"""Serving engines (port of ``repro.serve``): the static-batch engine, the
continuous-batching engine and the multi-replica router over it."""
from repro_torch.serve.continuous import ContinuousEngine, Request, RequestResult
from repro_torch.serve.engine import GenerationResult, ServeEngine
from repro_torch.serve.router import ReplicaRouter

__all__ = ["ContinuousEngine", "GenerationResult", "ReplicaRouter",
           "Request", "RequestResult", "ServeEngine"]
