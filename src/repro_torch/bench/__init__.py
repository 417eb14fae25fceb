"""The paper's benchmarks on the port: Tables 1, 2/3, 4 and 5 and Figures 2 and 5
(``python -m repro_torch.bench.run``)."""
