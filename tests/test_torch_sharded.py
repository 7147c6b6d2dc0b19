"""The port's engine sharded over ranks (``cbctmc_tpu_torch.parallel``) and
``models.training.shard_batch``, on gloo worlds of spawned processes on the
CPU, against the JAX package's ``parallel/sharded.py`` and the statistics of
tests/test_sharding.py.

Two worlds run once per module (tests/torch_sharded_ranks.py): four ranks
on a 2 x 2 (proj, photons) mesh run one projection, its dose variant and a
scan of 3 projections over the 2 proj rows (padding one slot); two ranks on
a 1 x 2 mesh take two speedup train steps on halves of each batch.

Tolerances: a sharded image is the sum of the per-rank runs of
``run_projection`` under the folded keys, recomputed here in one process:
equal to 1e-6 of the image's largest pixel (gloo sums the four float32
images in its own order). The statistical checks against a single run with
another key are tests/test_sharding.py's. Against the JAX package's
``run_projection_sharded`` / ``run_scan_sharded`` on the same scene, budget
and 2 x 2 mesh (4 of the 8 host devices tests/conftest.py makes): channel
totals within 4 combined standard errors, each side's spread from its own
samples. The sharded train step averages
the two halves' gradients where the whole batch's step takes one mean:
loss and parameters within 1e-6 (at the trainers' default rate of 1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbctmc_tpu.engine import ct as jct
from cbctmc_tpu.engine import tables as jtables
from cbctmc_tpu.engine import transport as jtransport
from cbctmc_tpu.parallel import sharded as jsharded
from cbctmc_tpu.physics.materials import default_material_set as jax_material_set
from cbctmc_tpu.physics.spectrum import Spectrum as JaxSpectrum
from cbctmc_tpu_torch.engine.ct import ScanGeometry, build_scan, select_projection
from cbctmc_tpu_torch.engine.rng import fold_in, make_key
from cbctmc_tpu_torch.engine.tables import build_device_tables, build_woodcock_table
from cbctmc_tpu_torch.engine.transport import EngineConfig, make_voxel_volume, run_projection
from cbctmc_tpu_torch.models import training
from cbctmc_tpu_torch.models.speedup_net import MCSpeedUpNet
from cbctmc_tpu_torch.parallel import sharded
from cbctmc_tpu_torch.physics.materials import default_material_set
from cbctmc_tpu_torch.physics.spectrum import Spectrum
from torch_sharded_ranks import run_world

torch.set_num_threads(2)

N_PIX = 16
CONFIG = EngineConfig(n_lanes=1 << 10, max_virtual_trips=4)  # tests/test_sharding.py
DOSE_CONFIG = EngineConfig(n_lanes=1 << 10, max_virtual_trips=4, tally_dose=True)
N_HIST = 40_000
DOSE_HIST = 8_000
SCAN_ANGLES = (270.0, 342.0, 54.0)
SCAN_HIST = 5_000
KEY = make_key(7)
TOL = 1e-6
# against the JAX package: the 3 views REPS times over in one scan (21
# projections, so the 2 proj rows pad one slot), REP_HISTORIES each; view 0
# sharded under PROJECTION_KEYS keys on each side
REPS = 7
REP_HISTORIES = 10_000
PROJECTION_KEYS = 8
GEOMETRY = dict(
    n_pixels_x=N_PIX, n_pixels_z=N_PIX, detector_size_x=20.0, detector_size_z=20.0,
    sdd=60.0, sad=40.0, aperture_phi1=-1.0, aperture_phi2=-1.0, aperture_theta=-1.0,
    source_position_0=(10.0, -30.0, 10.0),
)


def _slab(table_set):
    """tests/test_sharding.py's scene: a 16^3 air cube with a water slab."""
    air, water = table_set.material("air"), table_set.material("h2o")
    mats = np.full((16, 16, 16), air.number, np.uint8)
    dens = np.full((16, 16, 16), air.density, np.float32)
    mats[:, 6:10, :] = water.number
    dens[:, 6:10, :] = water.density
    max_density = np.zeros(table_set.n_materials, np.float32)
    np.maximum.at(max_density, mats.astype(int).reshape(-1) - 1, dens.reshape(-1))
    return mats, dens, max_density


def _scene():
    """tests/test_sharding.py's scene: a 16^3 air cube of 1.25 cm voxels with
    a water slab, a 60 keV line, a 16 x 16 detector."""
    table_set = default_material_set()
    mono = Spectrum("mono60", np.array([59_995.0, 60_005.0], np.float32),
                    np.array([1.0], np.float32))
    tables = build_device_tables(table_set, mono, device="cpu")
    mats, dens, max_density = _slab(table_set)
    woodcock = build_woodcock_table(table_set, max_density, device="cpu")
    volume = make_voxel_volume(mats.astype(np.int32) - 1, dens, (1.25,) * 3, device="cpu")
    source, detector = build_scan(ScanGeometry(**GEOMETRY), list(SCAN_ANGLES), device="cpu")
    return tables, woodcock, volume, source, detector


@pytest.fixture(scope="module")
def scene():
    return _scene()


@pytest.fixture(scope="module")
def engine_world(scene, tmp_path_factory):
    tables, woodcock, volume, source, detector = scene
    view = (select_projection(source, 0), select_projection(detector, 0))
    rep_views = build_scan(ScanGeometry(**GEOMETRY), list(SCAN_ANGLES) * REPS, device="cpu")
    inputs = dict(scene=(tables, woodcock, volume, *view), n_pix=N_PIX, n_histories=N_HIST,
                  key=KEY, config=CONFIG, dose_histories=DOSE_HIST, dose_config=DOSE_CONFIG,
                  scan_views=(source, detector), scan_projections=len(SCAN_ANGLES),
                  scan_histories=SCAN_HIST, rep_views=rep_views,
                  rep_projections=len(SCAN_ANGLES) * REPS, rep_histories=REP_HISTORIES,
                  rep_scan_key=make_key(21),
                  rep_projection_keys=[make_key(30 + k) for k in range(PROJECTION_KEYS)])
    return run_world("engine", 4, tmp_path_factory.mktemp("engine_world"), inputs)


def _single(scene, view, n, key, config=CONFIG):
    tables, woodcock, volume, source, detector = scene
    out = run_projection(tables, woodcock, volume, select_projection(source, view),
                         select_projection(detector, view), n, key, N_PIX, N_PIX,
                         config=config, device="cpu")
    if config.tally_dose:
        image, extras = out
        return image.clone(), extras["voxel_dose"].clone(), extras["material_dose"].clone()
    return out.clone()


@pytest.mark.parametrize("n,shards", [(10, 4), (8, 4), (3, 4), (0, 2), (2**33 + 5, 3),
                                      (1_190_000_000, 7)])
def test_split_histories_matches_jax(n, shards):
    got = sharded.split_histories(n, shards)
    want = jsharded.split_histories(n, shards)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert got.sum() == n


def test_fold_in_keys_distinct():
    keys = [fold_in(KEY, i) for i in range(4096)]
    assert len(set(keys)) == len(keys)
    assert KEY not in keys and fold_in(KEY, 0) != make_key(*KEY, 0)
    nested = {fold_in(fold_in(fold_in(KEY, i), j), k)
              for i in range(4) for j in range(4) for k in range(8)}
    assert len(nested) == 4 * 4 * 8
    assert fold_in(KEY, 3) == fold_in(KEY, 3)
    with pytest.raises(ValueError):
        fold_in(KEY, -1)


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        sharded.make_mesh(1, device_type="cpu")


class _FourShards:
    """A stand-in for a (1, 4) mesh: the budget check comes before any
    collective."""

    device_type = "cpu"

    def size(self, dim=None):
        return 4 if dim in (None, 1) else 1


@pytest.mark.parametrize("what", ["projection", "scan"])
def test_int32_overflowing_budget_refused(scene, what):
    """1.19e10 histories over 4 shards is 2.975e9 a shard: the JAX
    package's int32 cast wraps it, the port refuses it."""
    tables, woodcock, volume, source, detector = scene
    with pytest.raises(ValueError, match="int32"):
        if what == "projection":
            sharded.run_projection_sharded(
                _FourShards(), tables, woodcock, volume, select_projection(source, 0),
                select_projection(detector, 0), 11_900_000_000, KEY, N_PIX, N_PIX, CONFIG)
        else:
            sharded.run_scan_sharded(_FourShards(), tables, woodcock, volume, source,
                                     detector, 3, 11_900_000_000, KEY, N_PIX, N_PIX, CONFIG)
    # the JAX package's cast wraps the same budget silently
    wrapped = jsharded.split_histories(11_900_000_000, 4).astype(np.int32)
    assert (wrapped < 0).all()


def test_mesh_shape_and_names(engine_world):
    assert [r["shape"] for r in engine_world] == [(2, 2)] * 4
    assert [r["names"] for r in engine_world] == [("proj", "photons")] * 4
    assert [r["coordinate"] for r in engine_world] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    # the JAX package's refusal of a world the proj shards do not divide
    assert [r["indivisible"] for r in engine_world] == [
        "4 devices not divisible by 3 proj shards"] * 4


def test_sharded_projection_is_the_sum_of_folded_runs(scene, engine_world):
    budgets = sharded.split_histories(N_HIST, 4)
    want = sum(_single(scene, 0, int(budgets[r]), fold_in(KEY, r)).double() for r in range(4))
    scale = float(want.abs().max())
    for r in engine_world:
        assert r["image"].shape == (4, N_PIX, N_PIX) and r["image"].dtype == torch.float32
        assert float((r["image"].double() - want).abs().max()) <= TOL * scale
        assert torch.equal(r["image"], engine_world[0]["image"])  # replicated


def test_sharded_projection_matches_single_device_statistics(scene, engine_world):
    """tests/test_sharding.py:59-93 on the port."""
    img_sharded = engine_world[0]["image"].double().numpy()
    img_single = _single(scene, 0, N_HIST, make_key(8)).double().numpy()
    assert img_sharded.sum() <= N_HIST * 60_005.0
    assert img_sharded.sum() == pytest.approx(img_single.sum(), rel=0.02)
    mask = img_single[0] > 0
    rel = np.abs(img_sharded[0][mask] - img_single[0][mask]) / img_single[0][mask]
    assert np.median(rel) < 0.2


def test_sharded_dose_is_the_sum_of_folded_runs(scene, engine_world):
    budgets = sharded.split_histories(DOSE_HIST, 4)
    runs = [_single(scene, 0, int(budgets[r]), fold_in(KEY, r), DOSE_CONFIG) for r in range(4)]
    for k, name in enumerate(("image", "voxel_dose", "material_dose")):
        want = sum(run[k].double() for run in runs)
        scale = float(want.abs().max())
        assert scale > 0
        for r in engine_world:
            got = r["dose_image"] if name == "image" else r["dose"][name]
            assert got.shape == want.shape and torch.isfinite(got).all()
            assert float((got.double() - want).abs().max()) <= TOL * scale, name


def test_scan_sharded_pads_and_gathers(scene, engine_world):
    """3 projections over 2 proj rows: row 0 takes 0 and 1, row 1 takes 2
    and a padded slot of budget 0 that must not reach the stack; each
    projection is its row's photons sum under the nested folded keys."""
    budgets = sharded.split_histories(SCAN_HIST, 2)
    n_local = 2
    for r in engine_world:
        stack = r["scan"]
        assert stack.shape == (3, 4, N_PIX, N_PIX)
        assert torch.isfinite(stack).all()
        totals = stack.double().sum(dim=(1, 2, 3))
        assert (totals > 0).all() and (totals <= SCAN_HIST * 60_005.0).all()
        assert torch.equal(stack, engine_world[0]["scan"])  # every rank holds the stack
    stack = engine_world[0]["scan"].double()
    for g in range(3):
        i, local = divmod(g, n_local)
        want = sum(_single(scene, g, int(budgets[j]),
                           fold_in(fold_in(fold_in(KEY, i), j), local)).double()
                   for j in range(2))
        assert float((stack[g] - want).abs().max()) <= TOL * float(want.abs().max())


@pytest.fixture(scope="module")
def jax_sharded():
    """The JAX package's run_scan_sharded of the 21 projections and
    run_projection_sharded of view 0 under PROJECTION_KEYS keys on the same
    scene and budgets, on a 2 x 2 mesh of 4 host devices (the projection
    under jax.jit with the key its argument, so that it is traced once)."""
    table_set = jax_material_set()
    mono = JaxSpectrum("mono60", np.array([59_995.0, 60_005.0], np.float32),
                       np.array([1.0], np.float32))
    tables = jtables.build_device_tables(table_set, mono)
    mats, dens, max_density = _slab(table_set)
    woodcock = jtables.build_woodcock_table(table_set, max_density)
    volume = jtransport.make_voxel_volume(mats.astype(np.int32) - 1, dens, (1.25,) * 3)
    config = jtransport.EngineConfig(n_lanes=CONFIG.n_lanes,
                                     max_virtual_trips=CONFIG.max_virtual_trips)
    source, detector = jct.build_scan(jct.ScanGeometry(**GEOMETRY), list(SCAN_ANGLES) * REPS)
    mesh = jsharded.make_mesh(2, devices=jax.devices()[:4])
    scan = jsharded.run_scan_sharded(mesh, tables, woodcock, volume, source, detector,
                                     len(SCAN_ANGLES) * REPS, REP_HISTORIES,
                                     jax.random.PRNGKey(21), N_PIX, N_PIX, config)
    view = [jax.tree.map(lambda x: jnp.asarray(x[0]), v) for v in (source, detector)]
    projection = jax.jit(lambda key: jsharded.run_projection_sharded(
        mesh, tables, woodcock, volume, *view, REP_HISTORIES, key, N_PIX, N_PIX, config))
    images = [projection(jax.random.PRNGKey(30 + k)) for k in range(PROJECTION_KEYS)]
    return np.asarray(scan, np.float64), np.asarray(images, np.float64)


def _per_view_totals(stack):
    """[REPS * views, 4, z, x] -> channel totals [REPS, views, 4]."""
    totals = np.asarray(stack, np.float64).sum(axis=(-2, -1))
    return totals.reshape(REPS, len(SCAN_ANGLES), 4)


def test_scan_sharded_matches_the_jax_package(engine_world, jax_sharded):
    """The port's run_scan_sharded of the 3 views 7 times over against the
    JAX package's on the same scene, budget and mesh: the same stack shape
    (the padded 22nd slot in neither), every projection filled, and for each
    view and channel the mean of the 7 samples within 4 combined standard
    errors of JAX's."""
    got, want = engine_world[0]["rep_scan"], jax_sharded[0]
    assert tuple(got.shape) == want.shape == (len(SCAN_ANGLES) * REPS, 4, N_PIX, N_PIX)
    assert all(torch.equal(r["rep_scan"], got) for r in engine_world)
    a, b = _per_view_totals(got), _per_view_totals(want)
    assert (a > 0).all() and (b > 0).all()
    limit = 4.0 * np.sqrt(a.var(axis=0, ddof=1) / REPS + b.var(axis=0, ddof=1) / REPS)
    assert (np.abs(a.mean(axis=0) - b.mean(axis=0)) <= limit).all(), (a.mean(0), b.mean(0), limit)


def test_projection_sharded_matches_the_jax_package(engine_world, jax_sharded):
    """The port's run_projection_sharded of view 0 against the JAX
    package's, 8 keys each at the same budget on the same mesh: the mean
    channel totals within 4 combined standard errors."""
    images = engine_world[0]["rep_images"]
    for r in engine_world:
        assert all(torch.equal(x, y) for x, y in zip(r["rep_images"], images))
    a = np.array([img.double().sum(dim=(1, 2)).numpy() for img in images])
    b = jax_sharded[1].sum(axis=(2, 3))
    assert a.shape == b.shape == (PROJECTION_KEYS, 4)
    assert (a > 0).all() and (b > 0).all()
    limit = 4.0 * np.sqrt(a.var(axis=0, ddof=1) / PROJECTION_KEYS
                          + b.var(axis=0, ddof=1) / PROJECTION_KEYS)
    assert (np.abs(a.mean(axis=0) - b.mean(axis=0)) <= limit).all(), (a.mean(0), b.mean(0), limit)


def _speedup_batches(n, rng, size=32, batch=4):
    out = []
    for _ in range(n):
        low = rng.gamma(4.0, 0.25, (batch, size, size)).astype(np.float32)
        fp = (low + rng.normal(0.0, 0.05, low.shape)).astype(np.float32)
        high = (0.9 * low + 0.1 + rng.normal(0.0, 0.02, low.shape)).astype(np.float32)
        out.append({"input": np.stack([low, fp], -1), "target": high[..., None]})
    return out


NET = dict(mean_filter_base=4, mean_levels=2, var_filter_base=2, var_levels=1)
# the trainers' default rate: an Adam step moves a parameter by about the
# rate, and rounding in the gradients' mean by a part of it where a gradient
# is near 0, so the 1e-6 bound on the parameters is 1e-2 of this rate
TRAINER = dict(learning_rate=1e-4, n_pretrain_steps=1)


@pytest.fixture(scope="module")
def train_world(tmp_path_factory):
    batches = _speedup_batches(2, np.random.default_rng(3))
    params = training.flax_init(MCSpeedUpNet(**NET), torch.Generator().manual_seed(0))
    inputs = dict(net=NET, trainer=TRAINER, params=params, batches=batches)
    ranks = run_world("train", 2, tmp_path_factory.mktemp("train_world"), inputs)
    return batches, params, ranks


@pytest.mark.parametrize("step", [0, 1], ids=["l1_pretrain", "gaussian_nll"])
def test_sharded_train_step_is_the_whole_batch_step(train_world, step):
    """Two steps (the L1 pre-training step, then the first NLL step) on two
    ranks with half a batch each equal the single-process steps on the whole
    batches: the loss and every parameter within 1e-6. From the second step
    on, a convolution bias that an instance norm follows has a gradient
    that is 0 in exact arithmetic; Adam scales its rounding noise, which
    the two sums round differently, to a part of the rate, so those are
    held within the most two Adam steps can part them, 2 x rate a step."""
    batches, params, ranks = train_world
    trainer = training.SpeedupTrainer(MCSpeedUpNet(**NET), device="cpu", **TRAINER)
    state = (params, trainer.optimizer.init(params))
    for k in range(step + 1):
        loss, grads = trainer.gradients(state[0], trainer.to_device(batches[k]), k)
        p, o, loss = trainer._train_step(*state, trainer.to_device(batches[k]), k)
        state = (p, o)
    g_max = max(float(g.abs().max()) for g in grads.values())
    for r in ranks:
        got = r["steps"][step]
        assert got["rows"] == 2
        assert got["loss"] == pytest.approx(float(loss), rel=0, abs=TOL)
        for name, value in state[0].items():
            null = step > 0 and float(grads[name].abs().max()) < 1e-6 * g_max
            bound = 2 * TRAINER["learning_rate"] * (step + 1) if null else TOL
            assert float((got["params"][name] - value).abs().max()) <= bound, name


def test_shard_batch_refuses_an_indivisible_batch(train_world):
    assert all(r["refused_odd_batch"] for r in train_world[2])
