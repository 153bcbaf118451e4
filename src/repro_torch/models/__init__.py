"""Models on the port: GAT inference through the fused SpMM handle
(``gnn``) and the dense / MoE language models (``transformer``, with
``layers``, ``moe`` and ``config``)."""
