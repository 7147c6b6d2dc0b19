"""The port's package boundary: it imports neither JAX nor any module of the
JAX package, and its entry points run on the card unless the caller asks
for the CPU."""

import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cbctmc_tpu_torch.engine.device import resolve_device

REPO = Path(__file__).resolve().parent.parent

SLICE_MODULES = [
    "cbctmc_tpu_torch",
    "cbctmc_tpu_torch.interop",
    "cbctmc_tpu_torch.physics.constants",
    "cbctmc_tpu_torch.physics.materials",
    "cbctmc_tpu_torch.physics.spectrum",
    "cbctmc_tpu_torch.geometry.mc_geometry",
    "cbctmc_tpu_torch.geometry.phantoms",
    "cbctmc_tpu_torch.engine.device",
    "cbctmc_tpu_torch.engine.rng",
    "cbctmc_tpu_torch.engine.ct",
    "cbctmc_tpu_torch.engine.tables",
    "cbctmc_tpu_torch.engine.samplers",
    "cbctmc_tpu_torch.engine.kernels",
    "cbctmc_tpu_torch.engine.transport",
    "cbctmc_tpu_torch.engine.simulate",
    "cbctmc_tpu_torch.engine.primary",
    "cbctmc_tpu_torch.physics.reference_values",
    "cbctmc_tpu_torch.pipeline.fast_scan",
    "cbctmc_tpu_torch.pipeline.reconstruction",
    "cbctmc_tpu_torch.recon.geometry",
    "cbctmc_tpu_torch.recon.fdk",
    "cbctmc_tpu_torch.recon.joseph",
    "cbctmc_tpu_torch.recon.shearwarp",
    "cbctmc_tpu_torch.recon.rooster",
    "cbctmc_tpu_torch.utils.io",
    "cbctmc_tpu_torch.analysis.metrics",
    "cbctmc_tpu_torch.analysis.peaks",
    "cbctmc_tpu_torch.analysis.binning",
    "cbctmc_tpu_torch.registration.demons",
    "cbctmc_tpu_torch.pipeline.respiratory",
    "cbctmc_tpu_torch.pipeline.correspondence",
    "cbctmc_tpu_torch.pipeline.simulation",
    "cbctmc_tpu_torch.analysis.mtf",
    "cbctmc_tpu_torch.pipeline.wpc_fit",
    "cbctmc_tpu_torch.pipeline.evaluation",
    "cbctmc_tpu_torch.pipeline.noise_fit",
    "cbctmc_tpu_torch.pipeline.mtf_workflow",
    "cbctmc_tpu_torch.utils.logging",
    "cbctmc_tpu_torch.recon.rtk_interop",
    "cbctmc_tpu_torch.utils.profiling",
    "cbctmc_tpu_torch.models.checkpoints",
    "cbctmc_tpu_torch.models.flex_unet",
    "cbctmc_tpu_torch.models.speedup_net",
    "cbctmc_tpu_torch.models.segmentation",
    "cbctmc_tpu_torch.models.speedup_inference",
    "cbctmc_tpu_torch.geometry.mappers",
    "cbctmc_tpu_torch.pipeline.patient",
    "cbctmc_tpu_torch.cli",
    "cbctmc_tpu_torch.models.losses",
    "cbctmc_tpu_torch.models.experimental",
    "cbctmc_tpu_torch.models.training",
    "cbctmc_tpu_torch.models.datasets",
    "cbctmc_tpu_torch.models.real_ct",
    "cbctmc_tpu_torch.models.synthetic_ct",
    "cbctmc_tpu_torch.pipeline.training_workflows",
    "cbctmc_tpu_torch.physics.material_generator",
    "cbctmc_tpu_torch.native",
    "cbctmc_tpu_torch.utils.interchange",
    "cbctmc_tpu_torch.utils.common",
]
# the port's scripts, imported as modules (scripts/ on the path)
PORT_SCRIPTS = ["torch_validation_records"]

_PROBE = """
import importlib, json, sys
sys.modules["jax"] = None  # any 'import jax' now raises ImportError
sys.path.insert(0, "scripts")
for name in {modules!r}:
    importlib.import_module(name)
print(json.dumps(sorted(k for k, v in sys.modules.items() if v is not None)))
"""


def test_port_imports_without_jax_or_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(modules=SLICE_MODULES + PORT_SCRIPTS)],
        cwd=REPO, capture_output=True, text=True, timeout=120, check=True,
    )
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(SLICE_MODULES + PORT_SCRIPTS) <= set(loaded)
    # exact names: cbctmc_tpu_torch itself starts with "cbctmc_tpu"
    offending = [m for m in loaded if m == "cbctmc_tpu" or m.startswith("cbctmc_tpu.")]
    assert offending == []
    for package in ("jax", "flax", "msgpack"):
        assert not any(m == package or m.startswith(f"{package}.") for m in loaded), package


def test_port_sources_name_no_jax_import():
    scripts = [REPO / "scripts" / f"{name}.py" for name in PORT_SCRIPTS]
    for path in [*(REPO / "cbctmc_tpu_torch").rglob("*.py"), *scripts]:
        text = path.read_text()
        for needle in ("import jax", "from jax", "import cbctmc_tpu\n", "from cbctmc_tpu.",
                       "import flax", "from flax", "import msgpack", "from msgpack"):
            assert needle not in text, f"{path.name}: {needle.strip()}"


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_mcscanner_without_device_raises_when_cuda_is_absent(monkeypatch):
    from cbctmc_tpu_torch.engine.simulate import MCScanner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mats = np.ones((4, 4, 4), np.uint8)
    dens = np.full((4, 4, 4), 1.0e-3, np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MCScanner(mats, dens, (1.0, 1.0, 1.0))


@pytest.mark.parametrize("entry", ["make_scene", "build_device_tables", "make_voxel_volume"])
def test_entry_points_default_to_cuda(entry, monkeypatch):
    from cbctmc_tpu_torch.engine import tables, transport
    from cbctmc_tpu_torch.physics.materials import default_material_set
    from cbctmc_tpu_torch.physics.spectrum import default_spectrum

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ts = default_material_set()
    mats = np.zeros((4, 4, 4), np.int32)
    dens = np.full((4, 4, 4), 1.0e-3, np.float32)
    call = {
        "make_scene": lambda: transport.make_scene(ts, mats, dens, (0.1,) * 3),
        "build_device_tables": lambda: tables.build_device_tables(ts, default_spectrum()),
        "make_voxel_volume": lambda: transport.make_voxel_volume(mats, dens, (0.1,) * 3),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_run_projection_defaults_to_cuda(monkeypatch):
    from cbctmc_tpu_torch.engine.ct import ScanGeometry, build_scan, select_projection
    from cbctmc_tpu_torch.engine.rng import make_key
    from cbctmc_tpu_torch.engine.tables import build_device_tables
    from cbctmc_tpu_torch.engine.transport import EngineConfig, make_scene, run_projection
    from cbctmc_tpu_torch.physics.materials import default_material_set
    from cbctmc_tpu_torch.physics.spectrum import default_spectrum

    ts = default_material_set()
    mats = np.zeros((4, 4, 4), np.int32)
    dens = np.full((4, 4, 4), 1.0e-3, np.float32)
    volume, woodcock = make_scene(ts, mats, dens, (0.5,) * 3, device="cpu")
    tables = build_device_tables(ts, default_spectrum(), device="cpu")
    geom = ScanGeometry(
        n_pixels_x=4, n_pixels_z=4, detector_size_x=4.0, detector_size_z=4.0,
        sdd=6.0, sad=4.0, aperture_phi1=-1.0, aperture_phi2=-1.0,
        aperture_theta=-1.0, source_position_0=(1.0, -3.0, 1.0),
    )
    src, det = build_scan(geom, [270.0], device="cpu")
    args = (tables, woodcock, volume, select_projection(src, 0), select_projection(det, 0),
            100, make_key(0), 4, 4)
    cfg = EngineConfig(n_lanes=64, max_virtual_trips=2)
    image = run_projection(*args, config=cfg, device="cpu")
    assert image.shape == (4, 4, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_projection(*args, config=cfg)


@pytest.mark.parametrize("entry", ["deterministic_primary", "uniform_clearance_volume",
                                   "sample_primary", "compose_fast_view", "compose_fast_scan",
                                   "filter_projections", "fdk_reconstruct"])
def test_fast_scan_and_fdk_entry_points_default_to_cuda(entry, monkeypatch):
    """The fast-scan / FDK slice's entry points run on the card unless the
    caller passes device="cpu"; without a card they raise."""
    from cbctmc_tpu_torch.engine import primary
    from cbctmc_tpu_torch.engine.ct import ScanGeometry, build_scan
    from cbctmc_tpu_torch.engine.transport import make_voxel_volume
    from cbctmc_tpu_torch.physics.materials import default_material_set
    from cbctmc_tpu_torch.physics.spectrum import default_spectrum
    from cbctmc_tpu_torch.pipeline import fast_scan
    from cbctmc_tpu_torch.recon import fdk
    from cbctmc_tpu_torch.recon.geometry import ConeBeamGeometry, VolumeGrid

    ts = default_material_set()
    volume = make_voxel_volume(np.zeros((4, 4, 4), np.int32), np.full((4, 4, 4), 1e-3, np.float32),
                               (0.5,) * 3, device="cpu")
    pv = primary.primary_volume(volume, device="cpu")
    geom = ScanGeometry(
        n_pixels_x=4, n_pixels_z=4, detector_size_x=4.0, detector_size_z=4.0,
        sdd=6.0, sad=4.0, aperture_phi1=-1.0, aperture_phi2=-1.0,
        aperture_theta=-1.0, source_position_0=(1.0, -3.0, 1.0),
    )
    src, det = build_scan(geom, [270.0], device="cpu")
    img = np.ones((4, 4), np.float32)
    cfg = fast_scan.FastScanConfig(n_histories_target=1e9, pixel_area_cm2=1.0)
    cone = ConeBeamGeometry(n_pixels_u=4, n_pixels_v=4, pixel_size_u=1.0, pixel_size_v=1.0,
                            detector_offset_u=0.0)
    proj = np.zeros((2, 4, 4), np.float32)
    call = {
        "deterministic_primary": lambda **kw: primary.deterministic_primary(
            pv, ts, default_spectrum(), geom, src, det, **kw),
        "uniform_clearance_volume": lambda **kw: primary.uniform_clearance_volume(volume, **kw),
        "sample_primary": lambda **kw: primary.sample_primary(
            torch.Generator(), img, img, 1e6, **kw),
        "compose_fast_view": lambda **kw: fast_scan.compose_fast_view(
            torch.Generator(), img, img, img, img, cfg, **kw),
        "compose_fast_scan": lambda **kw: fast_scan.compose_fast_scan(
            0, img[None], img[None], np.stack([img, img])[None], cfg, **kw),
        "filter_projections": lambda **kw: fdk.filter_projections(proj, cone, **kw),
        "fdk_reconstruct": lambda **kw: fdk.fdk_reconstruct(
            proj, cone, [0.0, 180.0], grid=VolumeGrid(shape=(4, 4, 2)), **kw),
    }[entry]
    call(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


@pytest.mark.parametrize("entry", ["project_forward", "shearwarp_project", "rooster_reconstruct",
                                   "reconstruct_3d", "reconstruct_4d"])
def test_recon_mc_entry_points_default_to_cuda(entry, monkeypatch, tmp_path):
    """The recon-mc slice's entry points run on the card unless the caller
    passes device="cpu"; without a card they raise."""
    from cbctmc_tpu_torch.pipeline import reconstruction
    from cbctmc_tpu_torch.recon import joseph, rooster, shearwarp
    from cbctmc_tpu_torch.recon.geometry import ConeBeamGeometry, VolumeGrid
    from cbctmc_tpu_torch.utils.io import write_image

    cone = ConeBeamGeometry(sad=400.0, sdd=600.0, n_pixels_u=8, n_pixels_v=4, pixel_size_u=8.0,
                            pixel_size_v=8.0, detector_offset_u=0.0)
    vol = np.ones((6, 6, 4), np.float32)
    proj = np.ones((4, 4, 8), np.float32)
    stack = tmp_path / "projections.mha"
    write_image(np.transpose(proj, (2, 1, 0)), stack, spacing=(8.0, 8.0, 1.0))
    par = rooster.RoosterParameters(n_phases=2, n_iterations=1, n_data_subiterations=1,
                                    n_tv_iterations=1, projector="joseph")
    phase = [0.0, 0.25, 0.5, 0.75]
    call = {
        "project_forward": lambda **kw: joseph.project_forward(vol, cone, [0.0, 90.0], **kw),
        "shearwarp_project": lambda **kw: shearwarp.shearwarp_project(vol, cone, [0.0], **kw),
        "rooster_reconstruct": lambda **kw: rooster.rooster_reconstruct(
            proj, cone, [0.0, 90.0, 180.0, 270.0], phase, grid=VolumeGrid(shape=(6, 6, 4)),
            parameters=par, **kw),
        "reconstruct_3d": lambda **kw: reconstruction.reconstruct_3d(
            stack, output_folder=tmp_path, dimension=(6, 4, 6), geometry=cone, **kw),
        "reconstruct_4d": lambda **kw: reconstruction.reconstruct_4d(
            stack, phase_signal=np.asarray(phase), output_folder=tmp_path, dimension=(6, 4, 6),
            geometry=cone, parameters=par, **kw),
    }[entry]
    call(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


@pytest.mark.parametrize("entry", ["register", "register_phases", "MCSimulation",
                                   "MCSimulation4D"])
def test_run_mc_entry_points_default_to_cuda(entry, monkeypatch):
    """The run-mc slice's entry points run on the card unless the caller
    passes device="cpu"; without a card they raise."""
    from cbctmc_tpu_torch.geometry.mc_geometry import MCGeometry
    from cbctmc_tpu_torch.pipeline.correspondence import CorrespondenceModel
    from cbctmc_tpu_torch.pipeline.simulation import MCSimulation, MCSimulation4D
    from cbctmc_tpu_torch.registration import demons

    vol = np.zeros((8, 8, 8), np.float32)
    vol[2:5, 3:6, 2:6] = 1.0
    geometry = MCGeometry(np.ones((4, 4, 4), np.uint8), np.ones((4, 4, 4), np.float32))
    fields = np.zeros((3, 3, 4, 4, 4), np.float32)
    model = CorrespondenceModel().fit(fields, np.array([[0.0, 0.5, 1.0], [1.0, 0.0, -1.0]]))
    params = demons.DemonsParameters(iterations=1, n_levels=1)
    call = {
        "register": lambda **kw: demons.register(np.roll(vol, 1, 0), vol, params, **kw),
        "register_phases": lambda **kw: demons.register_phases(
            np.stack([vol, np.roll(vol, 1, 0)]), reference_index=0, parameters=params, **kw),
        "MCSimulation": lambda **kw: MCSimulation(geometry=geometry, **kw),
        "MCSimulation4D": lambda **kw: MCSimulation4D(correspondence_model=model,
                                                      geometry=geometry, **kw),
    }[entry]
    call(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


@pytest.mark.parametrize("entry", ["reconstruct_projection_powers", "run_wpc_fit",
                                   "simulate_and_reconstruct_water", "run_noise_fit",
                                   "simulate_line_pair", "run_line_pair_simulations"])
def test_validation_entry_points_default_to_cuda(entry, monkeypatch, tmp_path):
    """The validation workflows' entry points run on the card unless the
    caller passes device="cpu" (tests/test_torch_validation.py runs each on
    the CPU); without a card they raise before any work."""
    from cbctmc_tpu_torch.pipeline import mtf_workflow, noise_fit, wpc_fit
    from cbctmc_tpu_torch.recon.geometry import ConeBeamGeometry, VolumeGrid

    cone = ConeBeamGeometry(n_pixels_u=4, n_pixels_v=4, pixel_size_u=1.0, pixel_size_v=1.0,
                            detector_offset_u=0.0)
    proj = np.zeros((2, 4, 4), np.float32)
    grid = VolumeGrid(shape=(4, 4, 2))
    call = {
        "reconstruct_projection_powers": lambda: wpc_fit.reconstruct_projection_powers(
            proj, cone, [0.0, 180.0], grid, n_orders=2),
        "run_wpc_fit": lambda: wpc_fit.run_wpc_fit(proj, cone, [0.0, 180.0], grid),
        "simulate_and_reconstruct_water": lambda: noise_fit.simulate_and_reconstruct_water(
            1000, n_projections=2, phantom_shape=(8, 8, 8)),
        "run_noise_fit": lambda: noise_fit.run_noise_fit(tmp_path, n_runs=1, n_projections=2,
                                                         phantom_shape=(8, 8, 8)),
        "simulate_line_pair": lambda: mtf_workflow.simulate_line_pair(
            2.0, 1000, n_projections=2, phantom_shape=(32, 32, 24)),
        "run_line_pair_simulations": lambda: mtf_workflow.run_line_pair_simulations(
            tmp_path, line_gaps=(2.0,), n_histories=1000, n_projections=2),
    }[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
    assert not (tmp_path / "noise_fit.json").exists() and not (tmp_path / "mtf.json").exists()


@pytest.mark.parametrize("name", ["segmenter/default.ckpt", "segmenter/default.eval.json",
                                  "speedup/default.ckpt", "speedup/default.eval.json"])
def test_model_assets_byte_identical(name):
    def sha(p):
        return hashlib.sha256(p.read_bytes()).hexdigest()

    ours = REPO / "cbctmc_tpu_torch" / "assets" / "models" / name
    assert not ours.is_symlink()
    assert sha(ours) == sha(REPO / "cbctmc_tpu" / "assets" / "models" / name)


@pytest.mark.parametrize("entry", ["geometry_from_ct", "MCSegmenter.segment",
                                   "MCSpeedup.from_checkpoint", "MCSpeedup.execute", "run_mc",
                                   "capture_trace"])
def test_cli_path_entry_points_default_to_cuda(entry, monkeypatch, tmp_path):
    """The CLI slice's entry points run on the card unless the caller passes
    device="cpu" (tests/test_torch_models.py and tests/test_torch_cli.py run
    each on the CPU); without a card they raise before any work."""
    from cbctmc_tpu_torch import cli
    from cbctmc_tpu_torch.geometry.mc_geometry import MCGeometry
    from cbctmc_tpu_torch.models import segmentation, speedup_inference
    from cbctmc_tpu_torch.models.flex_unet import FlexUNet
    from cbctmc_tpu_torch.models.speedup_net import MCSpeedUpNet
    from cbctmc_tpu_torch.pipeline import patient
    from cbctmc_tpu_torch.utils import profiling
    from cbctmc_tpu_torch.utils.io import write_image

    models = REPO / "cbctmc_tpu_torch" / "assets" / "models"
    ct = tmp_path / "ct.mha"
    write_image(np.full((8, 8, 8), -1000.0, np.float32), ct)
    body = np.ones((8, 8, 8), np.uint8)
    geometry = tmp_path / "scene.pkl.gz"
    MCGeometry(np.ones((4, 4, 4), np.uint8), np.ones((4, 4, 4), np.float32)).save(geometry)
    tiny = FlexUNet(n_channels=1, n_classes=9, n_levels=1, ndim=3, filter_base=2)
    small_net = MCSpeedUpNet(mean_filter_base=2, mean_levels=1, var_filter_base=2,
                             var_levels=1)
    low = np.ones((1, 16, 16), np.float32)
    call = {
        "geometry_from_ct": lambda **kw: patient.geometry_from_ct(
            ct, body_segmentation=body, **kw),
        "MCSegmenter.segment": lambda **kw: segmentation.MCSegmenter(
            tiny, patch_shape=(8, 8, 8), **kw).segment(np.zeros((8, 8, 8), np.float32)),
        "MCSpeedup.from_checkpoint": lambda **kw: speedup_inference.MCSpeedup.from_checkpoint(
            models / "speedup" / "default.ckpt", **kw),
        "MCSpeedup.execute": lambda **kw: speedup_inference.MCSpeedup(
            small_net, **kw).execute(low),
        "run_mc": lambda **kw: cli.run_mc(tmp_path / "out", geometry_filepath=geometry,
                                          dry_run=True, **kw),
        "capture_trace": lambda **kw: profiling.capture_trace(
            lambda: np.zeros(1), trace_dir=str(tmp_path / "trace"), **kw),
    }[entry]
    call(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_synthetic_ct_copy_is_the_scripts_text():
    """The port's synthetic-CT generator is the JAX package's script's code,
    character for character, from its constants to its generator (tests/
    test_torch_datasets.py holds the cases bit-equal too)."""
    script = (REPO / "scripts" / "generate_synthetic_ct.py").read_text()
    ours = (REPO / "cbctmc_tpu_torch" / "models" / "synthetic_ct.py").read_text()
    block = script[script.index("N_LABELS = 9"):script.index('if __name__ == "__main__":')]
    assert block.rstrip() in ours


@pytest.mark.parametrize("entry", ["SpeedupTrainer", "SegmentationTrainer", "run_speedup_pipeline",
                                   "train_speedup", "train_segmentation",
                                   "train_segmenter_synthetic"])
def test_training_entry_points_default_to_cuda(entry, monkeypatch, tmp_path):
    """The training slice's entry points run on the card unless the caller
    passes device="cpu" (tests/test_torch_training.py and
    tests/test_torch_datasets.py run each on the CPU); without a card they
    raise before any work."""
    from cbctmc_tpu_torch.models import training
    from cbctmc_tpu_torch.models.speedup_net import MCSpeedUpNet
    from cbctmc_tpu_torch.pipeline import training_workflows as tw

    net = MCSpeedUpNet(mean_filter_base=2, mean_levels=1, var_filter_base=2, var_levels=1)
    call = {
        "SpeedupTrainer": lambda **kw: training.SpeedupTrainer(net, **kw),
        "SegmentationTrainer": lambda **kw: training.SegmentationTrainer(net, **kw),
        "run_speedup_pipeline": lambda **kw: tw.run_speedup_pipeline(tmp_path / "run", **kw),
        "train_speedup": lambda **kw: tw.train_speedup(tmp_path / "data", tmp_path / "out", **kw),
        "train_segmentation": lambda **kw: tw.train_segmentation([], [], tmp_path / "out", **kw),
        "train_segmenter_synthetic": lambda **kw: tw.train_segmenter_synthetic(
            tmp_path / "data", tmp_path / "out", **kw),
    }[entry]
    if entry.endswith("Trainer"):
        assert call(device="cpu").device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
    assert not any(tmp_path.iterdir())


def test_failed_native_build_raises_and_falls_back_to_nothing(monkeypatch, tmp_path):
    """A missing compiler (or a failed build) raises from every codec: the
    port has no numpy fall-back on its path."""
    from cbctmc_tpu_torch import native

    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    mats, dens = np.ones(4, np.uint8), np.ones(4, np.float32)
    calls = [
        lambda: native.render_vox_lines(mats, dens),
        lambda: native.parse_ascii_floats("1 2 3", 3),
        lambda: native.accumulate_fixed_point(dens, np.zeros(4, np.int64), 2),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cannot be built"):
            call()
    assert native._lib is None and not any((tmp_path / "_build").iterdir())
    monkeypatch.setattr(native, "CXX", "false")  # a compiler that fails
    with pytest.raises(RuntimeError, match="failed to build"):
        native.parse_ascii_floats("1 2 3", 3)
    assert native._lib is None and not any((tmp_path / "_build").iterdir())
