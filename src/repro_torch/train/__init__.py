"""Training on the port: the elastic controller (``MeshPlan``,
``propose_mesh``, ``ElasticController``; port of ``repro/train/
elastic.py``), the LM's steps (``train.steps``: ``make_train_step``,
``make_prefill_step``, ``make_decode_step``) and the fault-tolerant loop
(``train.trainer``: ``TrainerConfig``, ``Trainer``).
"""
from .elastic import ElasticController, MeshPlan, propose_mesh

__all__ = ["MeshPlan", "propose_mesh", "ElasticController"]
