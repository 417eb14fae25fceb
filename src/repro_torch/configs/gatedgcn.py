"""gatedgcn [arXiv:2003.00982 benchmarking-gnns]: 16L d_hidden=70, gated
edge-feature aggregator. Counterpart of ``repro/configs/gatedgcn.py``, same
numbers; the registry sets d_feat / d_edge / n_classes / readout per shape
(``registry.gnn_config_for_shape``)."""
from repro_torch.models.gnn import GatedGCNConfig

FAMILY = "gnn"

FULL = GatedGCNConfig(n_layers=16, d_hidden=70, d_feat=1433, n_classes=7)

SMOKE = GatedGCNConfig(n_layers=3, d_hidden=16, d_feat=32, n_classes=4, remat=False)
