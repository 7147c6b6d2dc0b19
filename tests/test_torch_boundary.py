"""The port's package boundary: it imports neither JAX nor any module of the
JAX package, and its entry points run on the card unless the caller asks
for the CPU."""

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
]

_PROBE = """
import importlib, json, sys
sys.modules["jax"] = None  # any 'import jax' now raises ImportError
for name in {modules!r}:
    importlib.import_module(name)
print(json.dumps(sorted(k for k, v in sys.modules.items() if v is not None)))
"""


def test_port_imports_without_jax_or_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(modules=SLICE_MODULES)],
        cwd=REPO, capture_output=True, text=True, timeout=120, check=True,
    )
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(SLICE_MODULES) <= set(loaded)
    # exact names: cbctmc_tpu_torch itself starts with "cbctmc_tpu"
    offending = [m for m in loaded if m == "cbctmc_tpu" or m.startswith("cbctmc_tpu.")]
    assert offending == []
    assert not any(m == "jax" or m.startswith("jax.") for m in loaded)


def test_port_sources_name_no_jax_import():
    for path in (REPO / "cbctmc_tpu_torch").rglob("*.py"):
        text = path.read_text()
        for needle in ("import jax", "from jax", "import cbctmc_tpu\n", "from cbctmc_tpu."):
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
