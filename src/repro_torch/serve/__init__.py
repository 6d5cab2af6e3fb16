"""Batched serving over the port's executor (`pipeline_server`) and the
LM's fused prefill (`prefill`)."""
from repro_torch.serve.pipeline_server import PipelineServer, serve_offline

__all__ = ["PipelineServer", "serve_offline"]
