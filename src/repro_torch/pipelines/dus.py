"""Down-and-Up Sampling — paper §VI-C / Figure 7.

The port's own copy of `repro.pipelines.dus` (the port imports nothing from
`repro`); tests/test_torch_*.py hold the two copies equal.

Linear DAG: Dx (decimate x) -> Dy (decimate y) -> Ux (expand x) -> Uy
(expand y).  All four stages are convex binomial stencils, so every range
stays [0, 255] and static analysis gives alpha = 8 everywhere (Table VIII).
Note the flip side: because the kernels are convex (weights sum to 1 and
are non-negative), [0, 255] is also the *true* range of every stage — no
sound analysis, phase-split or not, can tighten the paper's DUS chain.

`build_extended` adds the stages a real down-up pyramid is built *for* —
a difference-of-Gaussians band on the decimated grid and the full-rate
reconstruction residual — where cross-boundary correlation is the whole
signal and alignment-blind analyses collapse to +-255.
"""
from __future__ import annotations

from repro_torch.core.graph import Pipeline
from repro_torch.dsl.builder import PipelineBuilder

BIN3 = [1, 2, 1]
BIN5 = [1, 4, 6, 4, 1]
SHARP3 = [1, 6, 1]     # center-heavy tent: >1/2 of the mass on the sample


def build() -> Pipeline:
    p = PipelineBuilder("dus")
    img = p.image("img", 0, 255)
    Dx = p.downsample("Dx", img, [BIN3], scale=1.0 / 4, stride=(1, 2))
    Dy = p.downsample("Dy", Dx, [[w] for w in BIN3], scale=1.0 / 4, stride=(2, 1))
    Ux = p.upsample("Ux", Dy, [BIN3], scale=1.0 / 4, factor=(1, 2))
    Uy = p.upsample("Uy", Ux, [[w] for w in BIN3], scale=1.0 / 4, factor=(2, 1))
    p.output(Uy)
    return p.build()


def build_extended() -> Pipeline:
    """DUS plus the pyramid's detail channels (scale-space extension).

    Two stages ride on the paper's chain:

      * ``D5``/``band`` — a second, wider decimated blur and the
        difference-of-Gaussians band ``Dy - D5`` on the coarse grid (the
        SIFT-style octave band).  The true band range is the +-255-scaled
        positive/negative mass of the 3x3-minus-5x5 binomial difference
        kernel, +-59.77 — but the two operands live behind stride-2
        producers, so an alignment-blind whole-DAG encoding cuts both and
        reports +-255.  Phase-split encoding recovers the exact aligned
        expansion (2 alpha bits).
      * ``res`` — the reconstruction residual ``img - Uy`` at full rate
        (Laplacian detail).  Every output phase correlates with the center
        tap of the down-up chain, tightening +-255 to +-239.06 (exact
        union over the four phases).
      * ``DyS``/``UyS``/``resS`` — a y-only down-up channel with the
        center-heavy ``SHARP3`` kernel and its residual.  Its two output
        phases *differ by an alpha bit*: the aligned phase keeps more than
        half the center pixel's mass (exact +-87.7, 8 bits) while the
        off-grid phase interpolates (+-223.1, 9 bits).  The union bound
        erases that split — this is the stage the per-phase alpha columns
        of `repro.analysis` exist for (one datapath per lattice residue).
    """
    p = PipelineBuilder("dus_ext")
    img = p.image("img", 0, 255)
    Dx = p.downsample("Dx", img, [BIN3], scale=1.0 / 4, stride=(1, 2))
    Dy = p.downsample("Dy", Dx, [[w] for w in BIN3], scale=1.0 / 4, stride=(2, 1))
    Ux = p.upsample("Ux", Dy, [BIN3], scale=1.0 / 4, factor=(1, 2))
    Uy = p.upsample("Uy", Ux, [[w] for w in BIN3], scale=1.0 / 4, factor=(2, 1))
    D5 = p.downsample("D5", img, [[r * c for c in BIN5] for r in BIN5],
                      scale=1.0 / 256, stride=(2, 2))
    band = p.define("band", Dy - D5)
    res = p.define("res", img - Uy)
    DyS = p.downsample("DyS", img, [[w] for w in SHARP3], scale=1.0 / 8,
                       stride=(2, 1))
    UyS = p.upsample("UyS", DyS, [[w] for w in SHARP3], scale=1.0 / 8,
                     factor=(2, 1))
    resS = p.define("resS", img - UyS)
    p.output(band)
    p.output(res)
    p.output(resS)
    return p.build()
