"""The port's ``run-mc`` layer against the JAX package's on the CPU: the
respiratory signal, the correspondence model, ``MCGeometry``'s warp, padding
and persistence, the CIRS thorax phantom, and the artifacts of
``MCSimulation`` / ``MCSimulation4D``.

The numpy modules are compared to the bit (they are the same numpy code).
The simulations run the port's engine on the CPU at a tiny size (a 24^3 scene,
a 32 x 16 detector, 1e4 histories); the JAX package's run of the same
orchestration replaces its scanner with a stub (the artifacts' names, the
bookkeeping files and the stacks' layout do not depend on the transport,
and the JAX engine's compile would take minutes), so file names,
``projection_geometries.yaml``, ``signal*.txt`` and the geometry files are
byte-equal and the stacks equal in shape and metadata. The scanners share
one build of the device tables (``simulate.shared_device_tables``; the CPU
takes ~7 s a build)."""

import gzip
import pickle

import numpy as np
import pytest
import torch

from cbctmc_tpu.engine import simulate as jsimulate
from cbctmc_tpu.geometry import mc_geometry as jmc_geometry
from cbctmc_tpu.geometry import phantoms as jphantoms
from cbctmc_tpu.pipeline import correspondence as jcorrespondence
from cbctmc_tpu.pipeline import respiratory as jrespiratory
from cbctmc_tpu.pipeline import simulation as jsimulation
from cbctmc_tpu.utils.io import read_image as jread_image

from cbctmc_tpu_torch.engine import simulate
from cbctmc_tpu_torch.engine.simulate import SimulationParameters
from cbctmc_tpu_torch.engine.transport import EngineConfig
from cbctmc_tpu_torch.geometry.mc_geometry import MCGeometry
from cbctmc_tpu_torch.geometry.phantoms import CIRSPhantomGeometry
from cbctmc_tpu_torch.physics.materials import default_material_set
from cbctmc_tpu_torch.pipeline import simulation
from cbctmc_tpu_torch.pipeline.correspondence import CorrespondenceModel
from cbctmc_tpu_torch.pipeline.respiratory import RespiratorySignal
from cbctmc_tpu_torch.utils.io import read_image

torch.set_num_threads(2)

# ---------------------------------------------------------------------------
# respiratory signal and correspondence model (numpy): equal to the bit
# ---------------------------------------------------------------------------
def test_respiratory_signal_matches_jax(tmp_path):
    for make in ("create_sin4", "create_cos4"):
        ours = getattr(RespiratorySignal, make)(total_seconds=4.0, period=4.0)
        theirs = getattr(jrespiratory.RespiratorySignal, make)(total_seconds=4.0, period=4.0)
        np.testing.assert_array_equal(ours.signal, theirs.signal)
        np.testing.assert_array_equal(ours.dt_signal, theirs.dt_signal)
        a, b = ours.resample(15.0), theirs.resample(15.0)
        np.testing.assert_array_equal(a.signal, b.signal)
        np.testing.assert_array_equal(a.dt_signal, b.dt_signal)
        for bins in (2, 5, 20):
            q = RespiratorySignal.quantize_signal(a.signal, bins)
            np.testing.assert_array_equal(q, jrespiratory.RespiratorySignal.quantize_signal(
                b.signal, bins))
            dq = RespiratorySignal.quantize_signal(a.dt_signal, bins)
            assert RespiratorySignal.get_unique_signals(q, dq) == \
                jrespiratory.RespiratorySignal.get_unique_signals(q, dq)
    rng = np.random.default_rng(0)
    masks = [rng.random((6, 6, 6)) > f for f in np.linspace(0.3, 0.7, 6)]
    times = np.linspace(0.0, 4.0, 6)
    ours = RespiratorySignal.from_masks(masks, times, target_total_seconds=12.0)
    theirs = jrespiratory.RespiratorySignal.from_masks(masks, times, target_total_seconds=12.0)
    np.testing.assert_array_equal(ours.signal, theirs.signal)
    np.testing.assert_array_equal(ours.dt_signal, theirs.dt_signal)
    ours.save(tmp_path / "signal.pkl")
    loaded = jrespiratory.RespiratorySignal.load(tmp_path / "signal.pkl")
    np.testing.assert_array_equal(loaded.signal, ours.signal)


def _fields_and_signals(shape=(6, 5, 4), t=6):
    rng = np.random.default_rng(1)
    signals = np.stack([np.sin(np.linspace(0, 2 * np.pi, t, endpoint=False)),
                        np.cos(np.linspace(0, 2 * np.pi, t, endpoint=False))])
    fields = (rng.normal(size=(t, 3, *shape)) + signals[0][:, None, None, None, None] * 2.0)
    return fields.astype(np.float32), signals


def test_correspondence_model_matches_jax_and_loads_a_jax_model(tmp_path):
    fields, signals = _fields_and_signals()
    ours = CorrespondenceModel().fit(fields, signals, reference_phase=2)
    theirs = jcorrespondence.CorrespondenceModel().fit(fields, signals, reference_phase=2)
    np.testing.assert_array_equal(ours.coefficients, theirs.coefficients)
    np.testing.assert_array_equal(ours.mean_vector_field, theirs.mean_vector_field)
    assert ours.model_hash == theirs.model_hash
    for s in ([0.3, -0.2], [1.0, 0.0], [0.12345, 0.5]):
        got = ours.predict(np.array(s))
        assert got.dtype == np.float64  # float32 coefficients times a float64 signal
        np.testing.assert_array_equal(got, theirs.predict(np.array(s)))
    # the JAX package's saved model (a pickle of a dict of numpy arrays) in the port
    path = theirs.save(tmp_path / "correspondence_model.pkl")
    loaded = CorrespondenceModel.load(path)
    assert loaded.model_hash == theirs.model_hash
    np.testing.assert_array_equal(loaded.predict(np.array([0.4, 0.1])),
                                  theirs.predict(np.array([0.4, 0.1])))
    assert ours.save(tmp_path / "ours.pkl").name == \
        theirs.save(tmp_path / "ours.pkl").name


def test_correspondence_model_load_refuses_a_pickled_instance(tmp_path):
    """Loading goes through the geometry's restricted unpickler: a pickled
    instance of the JAX package's model, or a dict holding a JAX array, is
    refused before its module is imported; a payload not a dict is too."""
    import jax.numpy as jnp

    fields, signals = _fields_and_signals()
    theirs = jcorrespondence.CorrespondenceModel().fit(fields, signals, reference_phase=2)
    cases = [(theirs, pickle.UnpicklingError), ({"coefficients": jnp.zeros(3)},
                                                pickle.UnpicklingError),
             ([theirs.coefficients], TypeError)]
    for i, (payload, error) in enumerate(cases):
        path = tmp_path / f"model_{i}.pkl"
        path.write_bytes(pickle.dumps(payload))
        with pytest.raises(error):
            CorrespondenceModel.load(path)


# ---------------------------------------------------------------------------
# MCGeometry and the CIRS phantom
# ---------------------------------------------------------------------------
def _geometry_arrays(shape=(9, 8, 7), seed=2):
    rng = np.random.default_rng(seed)
    mats = rng.integers(1, 6, shape).astype(np.uint8)
    dens = rng.uniform(0.001, 2.0, shape).astype(np.float32)
    mus = rng.uniform(0.0, 0.05, shape).astype(np.float32)
    return mats, dens, mus


@pytest.mark.parametrize("with_mus", [False, True])
def test_mc_geometry_warp_pad_save_match_jax(with_mus, tmp_path):
    mats, dens, mus = _geometry_arrays()
    kw = dict(materials=mats, densities=dens, mus=mus if with_mus else None,
              image_spacing=(2.0, 1.5, 1.0), image_origin=(1.0, 2.0, 3.0))
    ours, theirs = MCGeometry(**kw), jmc_geometry.MCGeometry(**kw)
    rng = np.random.default_rng(3)
    # displacements of whole and half voxels (ties round half to even) and
    # samples outside the grid (air)
    dvf = (np.round(rng.normal(scale=3.0, size=(3, *mats.shape)) * 2) / 2).astype(np.float32)
    for field in (dvf, dvf[None], dvf + np.float32(0.25)):
        a, b = ours.warp(field), theirs.warp(field)
        np.testing.assert_array_equal(a.materials, b.materials)
        np.testing.assert_array_equal(a.densities, b.densities)
        if with_mus:
            np.testing.assert_array_equal(a.mus, b.mus)
    with pytest.raises(ValueError):
        ours.warp(dvf[:, :-1])
    a, b = ours.pad_to_shape((12, 8, 10)), theirs.pad_to_shape((12, 8, 10))
    np.testing.assert_array_equal(a.materials, b.materials)
    np.testing.assert_array_equal(a.densities, b.densities)
    assert a.image_origin == b.image_origin and a.image_spacing == b.image_spacing
    assert ours.pad_to_shape(mats.shape) is ours
    # save: the same pickled payload; each package loads the other's file
    ours.save(tmp_path / "ours.pkl.gz")
    theirs.save(tmp_path / "theirs.pkl.gz")
    raw = [gzip.decompress((tmp_path / f"{n}.pkl.gz").read_bytes()) for n in ("ours", "theirs")]
    assert raw[0] == raw[1]
    loaded = MCGeometry.load(tmp_path / "theirs.pkl.gz")
    assert type(loaded) is MCGeometry
    np.testing.assert_array_equal(loaded.densities, dens)
    assert loaded.image_spacing == (2.0, 1.5, 1.0) and loaded.image_origin == (1.0, 2.0, 3.0)
    back = jmc_geometry.MCGeometry.load(tmp_path / "ours.pkl.gz")
    np.testing.assert_array_equal(back.materials, mats)


def test_mc_geometry_load_refuses_a_pickled_instance(tmp_path):
    """A legacy payload (a pickled instance of the JAX package's class) is
    refused before its module is imported; so is any payload not a dict."""
    mats, dens, _ = _geometry_arrays()
    legacy = tmp_path / "legacy.pkl.gz"
    with gzip.open(legacy, "wb") as f:
        pickle.dump(jmc_geometry.MCGeometry(mats, dens), f)
    with pytest.raises(pickle.UnpicklingError, match="cbctmc_tpu.geometry"):
        MCGeometry.load(legacy)
    listed = tmp_path / "list.pkl.gz"
    with gzip.open(listed, "wb") as f:
        pickle.dump([mats, dens], f)
    with pytest.raises(TypeError):
        MCGeometry.load(listed)


def test_cirs_phantom_matches_jax():
    kw = dict(shape=(40, 30, 16), image_spacing=(8.0, 8.0, 8.0))
    ours = CIRSPhantomGeometry.synthetic_thorax(**kw)
    theirs = jphantoms.CIRSPhantomGeometry.synthetic_thorax(**kw)
    np.testing.assert_array_equal(ours.materials, theirs.materials)
    np.testing.assert_array_equal(ours.densities, theirs.densities)
    center = (27, 16, 8)
    a = ours.place_insert(insert_center=center)
    b = theirs.place_insert(insert_center=center)
    assert isinstance(a, CIRSPhantomGeometry)
    np.testing.assert_array_equal(a.materials, b.materials)
    np.testing.assert_array_equal(a.densities, b.densities)
    a = ours.place_insert(shift=(0, 0, 2), insert_center=center)
    b = theirs.place_insert(shift=(0, 0, 2), insert_center=center)
    np.testing.assert_array_equal(a.densities, b.densities)
    a = ours.place_line_pair_insert(gap=8.0, insert_center=center, width=4)
    b = theirs.place_line_pair_insert(gap=8.0, insert_center=center, width=4)
    np.testing.assert_array_equal(a.materials, b.materials)
    np.testing.assert_array_equal(a.densities, b.densities)
    assert a.image_spacing == b.image_spacing
    for radius in (1.5, 4.0):
        np.testing.assert_array_equal(
            CIRSPhantomGeometry.create_spherical_mask(radius, (12, 10, 9), (5, 4.5, 4)),
            jphantoms.CIRSPhantomGeometry.create_spherical_mask(radius, (12, 10, 9), (5, 4.5, 4)))


# ---------------------------------------------------------------------------
# MCSimulation / MCSimulation4D: the artifacts against the JAX package's
# ---------------------------------------------------------------------------
def _tiny_setup(n_projections=2):
    ts = default_material_set()
    air, water = ts.material("air"), ts.material("h2o")
    shape = (24, 24, 24)
    mats = np.full(shape, air.number, np.uint8)
    dens = np.full(shape, air.density, np.float32)
    mats[8:16, 8:16, 8:16] = water.number
    dens[8:16, 8:16, 8:16] = water.density
    kw = dict(n_histories=10_000, n_projections=n_projections,
              angle_between_projections=360.0 / n_projections, n_detector_pixels=(32, 16),
              detector_size=(400.0, 200.0), source_polar_aperture=(-1.0, -1.0),
              source_azimuthal_aperture=-1.0)
    config = dict(n_lanes=1 << 12, max_virtual_trips=4)
    return (mats, dens), kw, config


class _StubScanner:
    """The JAX package's scanner replaced: images of the right shape, one
    value per view."""

    def __init__(self, materials, densities, image_spacing, parameters=None, engine_config=None):
        self.parameters = parameters

    def simulate(self, angles_deg=None, n_histories=None, seed=None, progress=True):
        p = self.parameters
        n = len(angles_deg) if angles_deg is not None else (
            len(p.projection_angles) or p.n_projections)
        images = np.ones((n, 4, p.n_detector_pixels[1], p.n_detector_pixels[0]))
        return images * np.arange(1, n + 1)[:, None, None, None], \
            jsimulate.SimulationRunInfo(n_histories=p.n_histories * n, wall_time_s=1.0)


def _names(folder):
    return sorted(str(p.relative_to(folder)) for p in folder.rglob("*") if p.is_file())


def _same_stack_layout(ours, theirs):
    a, meta_a = read_image(ours)
    b, meta_b = jread_image(theirs)
    assert a.shape == b.shape and a.dtype == b.dtype
    for key in ("spacing", "origin", "direction"):
        np.testing.assert_array_equal(meta_a[key], meta_b[key])
    return a


def test_mc_simulation_artifacts_match_jax(tmp_path, monkeypatch):
    (mats, dens), kw, config = _tiny_setup()
    monkeypatch.setattr(jsimulation, "MCScanner", _StubScanner)
    ours_dir, theirs_dir = tmp_path / "ours", tmp_path / "theirs"
    common = dict(n_pixels_half_fan_x=24, air_n_histories=20_000)
    ours = simulation.MCSimulation(
        geometry=MCGeometry(mats, dens, image_spacing=(8.0,) * 3),
        parameters=SimulationParameters(**kw), engine_config=EngineConfig(**config),
        device="cpu", **common)
    theirs = jsimulation.MCSimulation(
        geometry=jmc_geometry.MCGeometry(mats, dens, image_spacing=(8.0,) * 3),
        parameters=jsimulate.SimulationParameters(**kw), **common)
    run = dict(air_projection_denoise_kernel_size=(2.0, 2.0), seed=5)
    artifacts = ours.run_simulation(ours_dir, **run)
    theirs.run_simulation(theirs_dir, **run)
    assert _names(ours_dir) == _names(theirs_dir)
    assert set(artifacts) == {"total", "unscattered", "scattered", "normalized"}
    assert gzip.decompress((ours_dir / "geometry.pkl.gz").read_bytes()) == \
        gzip.decompress((theirs_dir / "geometry.pkl.gz").read_bytes())
    for name in _names(ours_dir):
        if name.endswith(".mha"):
            _same_stack_layout(ours_dir / name, theirs_dir / name)
        if name.endswith(".nii.gz"):
            np.testing.assert_array_equal(read_image(ours_dir / name)[0],
                                          jread_image(theirs_dir / name)[0])
    total = simulation._read_projection_stack(artifacts["total"])
    assert total.shape == (2, 16, 24) and (total >= 0).all() and total.sum() > 0
    assert np.isfinite(simulation._read_projection_stack(artifacts["normalized"])).all()
    # seeded: a second run into another folder gives the same stack
    again = ours.run_simulation(tmp_path / "again", **run)
    np.testing.assert_array_equal(simulation._read_projection_stack(again["total"]), total)
    assert ours.run_simulation(ours_dir) == {}  # idempotent


def _model(shape):
    t = 6
    signals = np.stack([np.sin(np.linspace(0, 2 * np.pi, t, endpoint=False)),
                        np.cos(np.linspace(0, 2 * np.pi, t, endpoint=False))])
    fields = np.zeros((t, 3, *shape), np.float32)
    fields[:, 2] = signals[0][:, None, None, None] * 2.0
    return fields, signals


def test_mc_simulation_4d_artifacts_match_jax(tmp_path, monkeypatch):
    (mats, dens), kw, config = _tiny_setup(n_projections=4)
    monkeypatch.setattr(jsimulation, "MCScanner", _StubScanner)
    fields, signals = _model(mats.shape)
    common = dict(n_pixels_half_fan_x=24, air_n_histories=20_000, frame_rate=15.0)
    ours = simulation.MCSimulation4D(
        correspondence_model=CorrespondenceModel().fit(fields, signals),
        geometry=MCGeometry(mats, dens, image_spacing=(8.0,) * 3),
        parameters=SimulationParameters(**kw), engine_config=EngineConfig(**config),
        device="cpu", **common)
    theirs = jsimulation.MCSimulation4D(
        correspondence_model=jcorrespondence.CorrespondenceModel().fit(fields, signals),
        geometry=jmc_geometry.MCGeometry(mats, dens, image_spacing=(8.0,) * 3),
        parameters=jsimulate.SimulationParameters(**kw), **common)
    run = dict(respiratory_signal_quantization=3, air_projection_denoise_kernel_size=(2.0, 2.0))
    signal = RespiratorySignal.create_sin4(total_seconds=0.5, period=0.5)
    jsignal = jrespiratory.RespiratorySignal.create_sin4(total_seconds=0.5, period=0.5)
    ours_dir, theirs_dir = tmp_path / "ours", tmp_path / "theirs"
    artifacts = ours.run_simulation(signal, ours_dir, **run)
    theirs.run_simulation(jsignal, theirs_dir, **run)
    names = _names(ours_dir)
    assert names == _names(theirs_dir)
    for name in ("projection_geometries.yaml", "signal.txt", "signal_quantized.txt"):
        assert (ours_dir / name).read_bytes() == (theirs_dir / name).read_bytes(), name
    states = [n for n in names if n.startswith("geometry_") and n.endswith(".pkl.gz")]
    quantized = np.loadtxt(ours_dir / "signal_quantized.txt")
    unique = RespiratorySignal.get_unique_signals(quantized[:, 0], quantized[:, 1])
    assert len(states) == len(unique) >= 2
    for name in states:
        assert gzip.decompress((ours_dir / name).read_bytes()) == \
            gzip.decompress((theirs_dir / name).read_bytes())
    for name in names:
        if name.endswith(".mha"):
            _same_stack_layout(ours_dir / name, theirs_dir / name)
    total = simulation._read_projection_stack(artifacts["total"])
    assert total.shape == (4, 16, 24) and (total.sum(axis=(1, 2)) > 0).all()


def test_motion_states_restart_the_random_streams(tmp_path, monkeypatch):
    """The reference's hazard, reproduced: each motion state's scan runs with
    the parameters' seed and numbers its views from 0, so the first view of
    every state draws from the same Philox key."""
    (mats, dens), kw, config = _tiny_setup(n_projections=4)
    fields, signals = _model(mats.shape)
    keys = []  # (state, seed, projection, chunk, key)
    state = {"n": -1}
    real_make_key, real_scanner = simulate.make_key, simulation.MCScanner

    def make_key(seed, projection=0, chunk=0):
        key = real_make_key(seed, projection, chunk)
        keys.append((state["n"], seed, projection, chunk, tuple(int(k) for k in key)))
        return key

    def scanner(*args, **kwargs):
        state["n"] += 1
        return real_scanner(*args, **kwargs)

    monkeypatch.setattr(simulate, "make_key", make_key)
    monkeypatch.setattr(simulation, "MCScanner", scanner)
    sim = simulation.MCSimulation4D(
        correspondence_model=CorrespondenceModel().fit(fields, signals),
        geometry=MCGeometry(mats, dens, image_spacing=(8.0,) * 3),
        parameters=SimulationParameters(**kw), engine_config=EngineConfig(**config),
        n_pixels_half_fan_x=24, air_n_histories=20_000, device="cpu")
    sim.run_simulation(RespiratorySignal.create_sin4(total_seconds=0.5, period=0.5), tmp_path,
                       respiratory_signal_quantization=3, run_air_simulation=False)
    first = [k for k in keys if k[2] == 0 and k[3] == 0]
    assert len({k[0] for k in first}) >= 2  # two motion states or more
    assert len({k[1:] for k in first}) == 1  # one seed, one key for all of them
    assert first[0][1] == SimulationParameters().random_seed
