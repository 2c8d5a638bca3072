"""Assigned GNN and recsys configs (published numbers), as in
`repro.configs.gnn_archs`.

gcn-cora   [arXiv:1609.02907; paper]   2L d16 mean/sym
dimenet    [arXiv:2003.03123]          6 blocks d128 bilinear8 sph7 rad6
gatedgcn   [arXiv:2003.00982; paper]   16L d70 gated
gin-tu     [arXiv:1810.00826; paper]   5L d64 sum, learnable eps
deepfm     [arXiv:1703.04247; paper]   39 fields, embed10, mlp 400-400-400, FM
"""

from __future__ import annotations

from repro_torch.configs.registry import ArchSpec, GNN_SHAPES, RECSYS_SHAPES, register
from repro_torch.models.deepfm import DeepFMConfig
from repro_torch.models.dimenet import DimeNetConfig
from repro_torch.models.gnn import GNNConfig


register(ArchSpec(
    name="gcn-cora",
    family="gnn",
    make_config=lambda: GNNConfig(
        "gcn-cora", kind="gcn", n_layers=2, d_hidden=16, d_in=1433, n_classes=7,
    ),
    make_reduced=lambda: GNNConfig(
        "gcn-small", kind="gcn", n_layers=2, d_hidden=8, d_in=32, n_classes=4,
    ),
    shapes=GNN_SHAPES,
    notes="paper's technique applies DIRECTLY: aggregation = ACC combine over "
          "the degree-bucketed ELL pack / segment_sum edge path",
))

register(ArchSpec(
    name="gin-tu",
    family="gnn",
    make_config=lambda: GNNConfig(
        "gin-tu", kind="gin", n_layers=5, d_hidden=64, d_in=64, n_classes=8,
        readout="graph",
    ),
    make_reduced=lambda: GNNConfig(
        "gin-small", kind="gin", n_layers=2, d_hidden=16, d_in=16, n_classes=4,
        readout="graph",
    ),
    shapes=GNN_SHAPES,
))

register(ArchSpec(
    name="gatedgcn",
    family="gnn",
    make_config=lambda: GNNConfig(
        "gatedgcn", kind="gatedgcn", n_layers=16, d_hidden=70, d_in=70,
        n_classes=8,
    ),
    make_reduced=lambda: GNNConfig(
        "gatedgcn-small", kind="gatedgcn", n_layers=3, d_hidden=16, d_in=16,
        n_classes=4,
    ),
    shapes=GNN_SHAPES,
))

register(ArchSpec(
    name="dimenet",
    family="dimenet",
    make_config=lambda: DimeNetConfig(
        "dimenet", n_blocks=6, d_hidden=128, n_bilinear=8, n_spherical=7,
        n_radial=6,
    ),
    make_reduced=lambda: DimeNetConfig(
        "dimenet-small", n_blocks=2, d_hidden=16, n_bilinear=2, n_spherical=3,
        n_radial=3, d_in=8,
    ),
    shapes=GNN_SHAPES,
    notes="triplet regime; fan-in capped (DimeNet++-style) on non-molecular "
          "graphs; positions synthesized for citation/product graphs "
          "(DESIGN.md §4)",
))

register(ArchSpec(
    name="deepfm",
    family="recsys",
    make_config=lambda: DeepFMConfig(
        "deepfm", n_fields=39, embed_dim=10, vocab_per_field=100_000,
        mlp=(400, 400, 400),
    ),
    make_reduced=lambda: DeepFMConfig(
        "deepfm-small", n_fields=8, embed_dim=6, vocab_per_field=64,
        mlp=(32, 32),
    ),
    shapes=RECSYS_SHAPES,
    notes="embedding table row-sharded over 'model'; lookup = take + "
          "segment_sum (EmbeddingBag kernel)",
))
