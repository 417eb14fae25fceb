"""The paper's offline experiments on the port (Tables 2/3)."""
