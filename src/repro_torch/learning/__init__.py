"""The learning stack's serving half: sampling (host and device
backends), GraphSAGE and the trainer's ``CALL gnn.infer`` bridge."""

from repro_torch.learning.gnn import GraphSAGE, params_from_reference
from repro_torch.learning.sampler import GraphSampler, SampledBatch
from repro_torch.learning.trainer import SageTrainer

__all__ = ["GraphSAGE", "GraphSampler", "SageTrainer", "SampledBatch",
           "params_from_reference"]
