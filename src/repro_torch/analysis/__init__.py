"""Bit-width plans (port of `repro.analysis`'s plan artifact)."""
from repro_torch.analysis.plan import BitwidthPlan, Provenance

__all__ = ["BitwidthPlan", "Provenance"]
