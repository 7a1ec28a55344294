"""BASELINE config-matrix smoke renders: Cube (real MTL texture) and
Renault12TL (37k faces) must render with their real materials through the
full pipeline (BASELINE.md forward-correctness rows; reduced resolution —
the full-res configs run on the GPU via BENCH_SCENE=cube|renault)."""
import os

import jax
import numpy as np
import pytest

from mafrixraytracing_tpu.integrator.path import PathTracerConfig, render_image
from mafrixraytracing_tpu.scene import assets
from mafrixraytracing_tpu.scene.compiler import compile_scene

CFG = PathTracerConfig(max_depth=3, rr_enable=False, backend="jnp")
pytestmark = [
    pytest.mark.slow,
    pytest.mark.skipif(not assets.have_reference_assets(),
                       reason="reference assets absent"),
]


def _render(builder, w, h, spp):
    cs = compile_scene(builder(w, h))
    img = render_image(cs.scene, cs.camera, w, h, spp, jax.random.key(0), CFG)
    return np.asarray(img)


def test_cube_renders_with_texture():
    img = _render(assets.cube_scene, 48, 48, 8)
    assert np.isfinite(img).all()
    assert img.max() > 0.05  # lit
    # the wall texture must produce intra-face color variation well above
    # what a flat-material cube would show on the visible faces
    center = img[12:36, 12:36]
    assert center.std() > 0.02, center.std()


def test_renault_renders():
    img = _render(assets.renault_scene, 32, 32, 4)
    assert np.isfinite(img).all()
    assert img.max() > 0.01
    # the car covers the frame center: some geometry must be hit
    assert (img.sum(axis=-1) > 0).mean() > 0.3
