"""Device meshes and the band-row sharding rule (port of `repro.launch`,
its band mesh only)."""
from repro_torch.launch.mesh import BandMesh, make_band_mesh
from repro_torch.launch.sharding import BASE_RULES, spec_for

__all__ = ["BandMesh", "make_band_mesh", "BASE_RULES", "spec_for"]
