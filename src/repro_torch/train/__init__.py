"""Training-side policy on the port: the elastic controller.

``MeshPlan``, ``propose_mesh`` and ``ElasticController`` (port of
``repro/train/elastic.py``). The trainer and its steps are ROADMAP item
17.
"""
from .elastic import ElasticController, MeshPlan, propose_mesh

__all__ = ["MeshPlan", "propose_mesh", "ElasticController"]
