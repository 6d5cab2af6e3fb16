"""Horn–Schunck Optical Flow — paper §VI-D, 30 stages.

The port's own copy of `repro.pipelines.optical_flow` (the port imports
nothing from `repro`); tests/test_torch_*.py hold the two copies equal.

10 pre-processing stages + 4 repetitions of a 5-stage set, exactly the
paper's structure (Table IX):

  pre:  It = Img2 - Img1
        Ix, Iy = 1/12-Sobel derivatives of Img1
        Ixx = Ix^2 ; Iyy = Iy^2
        Denom = alpha^2 + Ixx + Iyy
        commonX = Ix / Denom ; commonY = Iy / Denom
        Vx0 = -commonX * It  ; Vy0 = -commonY * It       (k=0 update, u_bar=0)
  iter k=1..4 (5 stages each):
        Avgx_k, Avgy_k = HS 3x3 average of Vx_{k-1}, Vy_{k-1}
        Common_k = (Ix*Avgx_k + Iy*Avgy_k + It) / Denom   (shared numerator/denominator)
        Vx_k = Avgx_k - Ix * Common_k
        Vy_k = Avgy_k - Iy * Common_k

The regularization constant is the standard Horn–Schunck alpha^2 = 100
(alpha = 10), as in the reference.
"""
from __future__ import annotations

from repro_torch.core.graph import Pipeline, Pow
from repro_torch.dsl.builder import PipelineBuilder
from repro_torch.pipelines.hcd import SOBEL_X, SOBEL_Y

ALPHA2 = 100.0
HS_AVG = [[1, 2, 1], [2, 0, 2], [1, 2, 1]]   # classic HS neighborhood average
N_ITERS = 4


def build(n_iters: int = N_ITERS) -> Pipeline:
    p = PipelineBuilder("optical_flow")
    img1 = p.image("img1", 0, 255)
    img2 = p.image("img2", 0, 255)

    It = p.define("It", img2 - img1)
    Ix = p.stencil("Ix", img1, SOBEL_X, scale=1.0 / 12)
    Iy = p.stencil("Iy", img1, SOBEL_Y, scale=1.0 / 12)
    Ixx = p.define("Ixx", Pow(Ix, 2))
    Iyy = p.define("Iyy", Pow(Iy, 2))
    denom = p.define("Denom", ALPHA2 + Ixx + Iyy)
    commonX = p.define("commonX", Ix / denom)
    commonY = p.define("commonY", Iy / denom)
    vx = p.define("Vx0", (0 - commonX) * It)
    vy = p.define("Vy0", (0 - commonY) * It)

    for k in range(1, n_iters + 1):
        avgx = p.stencil(f"Avgx{k}", vx, HS_AVG, scale=1.0 / 12)
        avgy = p.stencil(f"Avgy{k}", vy, HS_AVG, scale=1.0 / 12)
        common = p.define(f"Common{k}", (Ix * avgx + Iy * avgy + It) / denom)
        vx = p.define(f"Vx{k}", avgx - Ix * common)
        vy = p.define(f"Vy{k}", avgy - Iy * common)

    p.output(vx)
    p.output(vy)
    return p.build()


def build_pyramid(n_iters: int = 1) -> Pipeline:
    """Coarse-to-fine (2-level) Horn–Schunck pyramid.

    Both frames are binomial-blurred and decimated by (2, 2), one HS
    update runs at the coarse level, the coarse flow is nearest-expanded
    back to full rate (smoothed, x2 magnitude: one coarse pixel spans two
    fine pixels), and `n_iters` fine-level HS iterations refine it.
    """
    p = PipelineBuilder("of_pyramid")
    img1 = p.image("img1", 0, 255)
    img2 = p.image("img2", 0, 255)
    bin2d = [[r * c for c in (1, 2, 1)] for r in (1, 2, 1)]

    # -- coarse level: blur+decimate, one HS update from zero flow ---------
    c1 = p.downsample("cImg1", img1, bin2d, scale=1.0 / 16, stride=(2, 2))
    c2 = p.downsample("cImg2", img2, bin2d, scale=1.0 / 16, stride=(2, 2))
    cIt = p.define("cIt", c2 - c1)
    cIx = p.stencil("cIx", c1, SOBEL_X, scale=1.0 / 12)
    cIy = p.stencil("cIy", c1, SOBEL_Y, scale=1.0 / 12)
    cDenom = p.define("cDenom", ALPHA2 + Pow(cIx, 2) + Pow(cIy, 2))
    cVx = p.define("cVx0", (0 - cIx / cDenom) * cIt)
    cVy = p.define("cVy0", (0 - cIy / cDenom) * cIt)

    # -- expand flow to full rate (x2: coarse displacement in fine pixels) -
    vx = p.upsample("UVx", cVx, bin2d, scale=2.0 / 16, factor=(2, 2))
    vy = p.upsample("UVy", cVy, bin2d, scale=2.0 / 16, factor=(2, 2))

    # -- fine level: HS refinement seeded by the upsampled coarse flow -----
    It = p.define("It", img2 - img1)
    Ix = p.stencil("Ix", img1, SOBEL_X, scale=1.0 / 12)
    Iy = p.stencil("Iy", img1, SOBEL_Y, scale=1.0 / 12)
    denom = p.define("Denom", ALPHA2 + Pow(Ix, 2) + Pow(Iy, 2))
    for k in range(1, n_iters + 1):
        avgx = p.stencil(f"Avgx{k}", vx, HS_AVG, scale=1.0 / 12)
        avgy = p.stencil(f"Avgy{k}", vy, HS_AVG, scale=1.0 / 12)
        common = p.define(f"Common{k}", (Ix * avgx + Iy * avgy + It) / denom)
        vx = p.define(f"Vx{k}", avgx - Ix * common)
        vy = p.define(f"Vy{k}", avgy - Iy * common)
    p.output(vx)
    p.output(vy)
    return p.build()


def stage_families(n_iters: int = N_ITERS):
    """Grouping used by the benchmark table (paper groups by family)."""
    fams = {
        "Img1,Img2": ["img1", "img2"], "It": ["It"], "Ix,Iy": ["Ix", "Iy"],
        "Ixx,Iyy": ["Ixx", "Iyy"], "Denom": ["Denom"],
        "commonX,commonY": ["commonX", "commonY"], "Vx0,Vy0": ["Vx0", "Vy0"],
    }
    for k in range(1, n_iters + 1):
        fams[f"Avg(iter{k})"] = [f"Avgx{k}", f"Avgy{k}"]
        fams[f"Common(iter{k})"] = [f"Common{k}"]
        fams[f"V(iter{k})"] = [f"Vx{k}", f"Vy{k}"]
    return fams
