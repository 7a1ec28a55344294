"""Multi-device tests on the virtual 8-CPU mesh (SURVEY §4): sharded render
must equal single-device render bit-for-bit (RNG keys are positional)."""
import jax
import jax.numpy as jnp
import numpy as np

from mafrixraytracing_tpu.integrator.path import PathTracerConfig
from mafrixraytracing_tpu.parallel.mesh import make_mesh
from mafrixraytracing_tpu.parallel.render import (
    _render_flat_pixels,
    render_image_sharded,
    render_spp_sharded,
)
from mafrixraytracing_tpu.scene.builtin import cornell_box
from mafrixraytracing_tpu.scene.compiler import compile_scene

CFG = PathTracerConfig(backend="jnp", max_depth=3, rr_enable=False)
W = H = 16


def _scene():
    cs = compile_scene(cornell_box(width=W, height=H))
    return cs.scene, cs.camera


def test_sharded_matches_single_device():
    scene, camera = _scene()
    key = jax.random.key(11)
    mesh8 = make_mesh(8)
    mesh1 = make_mesh(1)
    img8 = render_image_sharded(scene, camera, mesh8, W, H, 2, key, CFG)
    img1 = render_image_sharded(scene, camera, mesh1, W, H, 2, key, CFG)
    np.testing.assert_array_equal(np.asarray(img8), np.asarray(img1))


def test_sharded_matches_unsharded_reference():
    scene, camera = _scene()
    key = jax.random.key(11)
    mesh8 = make_mesh(8)
    img8 = render_image_sharded(scene, camera, mesh8, W, H, 2, key, CFG)
    ids = jnp.arange(W * H, dtype=jnp.int32)
    ref = _render_flat_pixels(scene, camera, ids, W, H, 2, key, CFG).reshape(H, W, 3)
    np.testing.assert_array_equal(np.asarray(img8), np.asarray(ref))


def test_spp_sharded_runs_and_averages():
    scene, camera = _scene()
    mesh8 = make_mesh(8)
    img = render_spp_sharded(scene, camera, mesh8, W, H, 1, jax.random.key(3), CFG)
    assert img.shape == (H, W, 3)
    assert np.isfinite(np.asarray(img)).all()
    assert float(img.max()) > 0.0


def test_nondivisible_pixel_count():
    scene, camera = _scene()
    mesh = make_mesh(8)
    # 15x15 = 225 pixels, not divisible by 8 -> padding path
    img = render_image_sharded(scene, camera, mesh, 15, 15, 1, jax.random.key(0), CFG)
    assert img.shape == (15, 15, 3)
    assert np.isfinite(np.asarray(img)).all()


def test_multihost_launch_single_process():
    """`parallel.launch.init` is a no-op single-process (returns False) and
    the global mesh covers all local devices (SURVEY §2.15 multi-host
    entry; real pod-slice behavior needs real hosts, exercised by the same
    mesh code path)."""
    from mafrixraytracing_tpu.parallel import launch

    assert launch.init() is False  # no coordination configured
    mesh = launch.global_mesh()
    assert mesh.devices.size == len(jax.devices())
    info = launch.process_info()
    assert info["process_count"] == 1
    assert info["global_devices"] == len(jax.devices())


def test_overlap_microbatched_train_step():
    """`overlap_microbatches=M` (per-microbatch gradient pmean, unrolled so
    XLA can overlap the all-reduce with the next microbatch's backward
    — round-4 VERDICT weak #4) must produce finite, sane training steps on
    the 8-device mesh, with the M sub-sample sets partitioning the sample
    budget (no RNG reuse: the two estimators agree within MC noise)."""
    import optax

    from mafrixraytracing_tpu.opt import inverse

    scene, camera = _scene()
    mesh = make_mesh(8)
    opt = optax.adam(1e-2)
    params = inverse.extract_params(scene, ("mat_albedo",))
    target = jnp.full((16, 16, 3), 0.25, jnp.float32)

    results = {}
    for M in (1, 2):
        step = inverse.make_train_step(mesh, opt, 16, 16, 4, CFG,
                                       overlap_microbatches=M)
        p, o, loss, gnorm = jax.jit(step)(
            params, opt.init(params), scene, camera, target,
            jax.random.key(5),
        )
        assert np.isfinite(float(loss)) and np.isfinite(float(gnorm))
        assert float(gnorm) > 0.0
        results[M] = (float(loss), np.asarray(p["mat_albedo"]))
    # same sample budget, same streams (partitioned): losses agree closely
    assert abs(results[1][0] - results[2][0]) < 0.25 * abs(results[1][0]) + 1e-3
    assert np.isfinite(results[2][1]).all()
