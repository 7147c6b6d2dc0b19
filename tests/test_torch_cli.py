"""The port's command-line interface against the JAX package's on the CPU.

``run-mc`` runs from a tiny CT image (the packaged segmenter at a 32 x 32 x
16 patch, the mappers, the port's engine on the CPU at 2 views x 2e4
histories on a 64 x 32 detector, the Joseph forward projection, the packaged
speedup net, FDK) through the port's plain function; the JAX package's
``run-mc`` runs the same options with its scanner replaced by the stub of
``tests/test_torch_simulation.py`` (the artifacts' names do not depend on the
transport, and the JAX engine's compile would take minutes). The detector,
the forward projection's panel and FDK's grid are cut to that size in both
packages' modules by ``monkeypatch``. Compared: the file names, the
segmented scene (equal), ``density_fp.mha`` against the JAX package's
``_forward_project_geometry`` of the port's scene (1e-5 of its max: the
march's FMA on XLA's side, as in ``tests/test_torch_joseph.py``) and
``geometry.xml`` (byte for byte); the 4D forward projection on one 4D run's
artifacts (1e-5 of its max); ``recon-mc`` with ``fdk3d`` (1e-5 of the
volume's max, as ``tests/test_torch_fdk.py`` holds FDK); ``fit-noise`` and
``run-mc-lp`` pass their options through; the click layer's help, usage
errors and ``--gpu``."""

import dataclasses
import functools
import json
from typing import Tuple

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from cbctmc_tpu import cli as jcli
from cbctmc_tpu.engine import simulate as jsimulate
from cbctmc_tpu.geometry import mc_geometry as jmc_geometry
from cbctmc_tpu.pipeline import correspondence as jcorrespondence
from cbctmc_tpu.pipeline import noise_fit as jnoise_fit
from cbctmc_tpu.pipeline import mtf_workflow as jmtf_workflow
from cbctmc_tpu.pipeline import reconstruction as jreconstruction
from cbctmc_tpu.pipeline import respiratory as jrespiratory
from cbctmc_tpu.pipeline import simulation as jsimulation
from cbctmc_tpu.recon import geometry as jrecon_geometry
from cbctmc_tpu.utils.io import read_image as jread_image
from cbctmc_tpu.utils.io import write_image as jwrite_image

from cbctmc_tpu_torch import cli
from cbctmc_tpu_torch.engine import simulate
from cbctmc_tpu_torch.geometry.mc_geometry import MCGeometry
from cbctmc_tpu_torch.pipeline import mtf_workflow, noise_fit, reconstruction
from cbctmc_tpu_torch.pipeline.simulation import _read_projection_stack
from cbctmc_tpu_torch.recon import geometry as recon_geometry
from cbctmc_tpu_torch.utils.io import read_image

from test_torch_models import _hu_volume
from test_torch_simulation import _StubScanner, _model, _names, _tiny_setup

torch.set_num_threads(4)

N_VIEWS = 2
PANEL = dict(n_pixels_u=64, n_pixels_v=32, pixel_size_u=6.208, pixel_size_v=6.208,
             detector_offset_u=0.0)
RECON = dict(dimension=(24, 16, 24), spacing=(4.0, 4.0, 4.0))
FP_TOL = 1e-5  # of the projections' max


def _small_parameters(base):
    @dataclasses.dataclass
    class Small(base):
        n_detector_pixels: Tuple[int, int] = (64, 32)
        detector_size: Tuple[float, float] = (397.312, 198.656)

    return Small


@pytest.fixture
def toy_size(monkeypatch):
    """The detector, the forward projection's panel and FDK's grid cut to a
    toy size in both packages."""
    for module, params in ((simulate, simulate.SimulationParameters),
                           (jsimulate, jsimulate.SimulationParameters)):
        monkeypatch.setattr(module, "SimulationParameters", _small_parameters(params))
    for module in (recon_geometry, jrecon_geometry):
        monkeypatch.setattr(module, "ConeBeamGeometry",
                            functools.partial(module.ConeBeamGeometry, **PANEL))
    for module in (reconstruction, jreconstruction):
        monkeypatch.setattr(module, "reconstruct_3d",
                            functools.partial(module.reconstruct_3d, **RECON))
    monkeypatch.setattr(jsimulation, "MCScanner", _StubScanner)


def _run_mc_options(ct_path):
    return dict(image_filepath=ct_path, speedups=(10.0,), reference_n_histories=200_000,
                segmenter_patch_shape=(32, 32, 16), segmenter_patch_overlap=0.5,
                n_projections=N_VIEWS, reconstruct_3d=True, do_forward_projection=True,
                air_n_histories=20_000.0, n_lanes=4096, random_seed=3)


def _jax_run_mc(**options):
    """The JAX package's click command with the same options."""
    args = []
    for name, value in options.items():
        flag = "--" + name.replace("_", "-")
        flag = {"--do-forward-projection": "--forward-projection",
                "--reference-sim": "--reference"}.get(flag, flag)
        if value is True:
            args.append(flag)
        elif isinstance(value, tuple) and name == "speedups":
            for v in value:
                args += [flag, str(v)]
        elif isinstance(value, tuple):
            args += [flag, *map(str, value)]
        elif value not in (None, False):
            args += [flag, str(value)]
    result = CliRunner().invoke(jcli.run_mc, args, catch_exceptions=False)
    assert result.exit_code == 0, result.output


def test_run_mc_from_a_ct_image_matches_jax(toy_size, tmp_path):
    ct_path = tmp_path / "patient_ct.mha"
    jwrite_image(_hu_volume(), ct_path)
    options = _run_mc_options(ct_path)
    folder = cli.run_mc(tmp_path / "ours", device="cpu", **options)
    assert folder == tmp_path / "ours" / "patient_ct"
    _jax_run_mc(output_folder=tmp_path / "theirs", **options)
    sim = folder / "speedup_10.00x"
    theirs = tmp_path / "theirs" / "patient_ct" / "speedup_10.00x"
    names = _names(sim)
    assert names == _names(theirs)
    for name in ("projections_total_speedup.mha", "density_fp.mha", "geometry.xml",
                 "reconstructions/recon_fdk3d.mha", "reconstructions/recon_fdk3d.yaml",
                 "projections_total_normalized.mha", "air/projections_total.mha"):
        assert name in names, name
    # the segmented scene, the stacks' shapes
    np.testing.assert_array_equal(read_image(sim / "geometry_materials.nii.gz")[0],
                                  jread_image(theirs / "geometry_materials.nii.gz")[0])
    low = _read_projection_stack(sim / "projections_total.mha")
    fast = _read_projection_stack(sim / "projections_total_speedup.mha")
    assert low.shape == fast.shape == (N_VIEWS, 32, 64)
    assert np.isfinite(fast).all() and (fast >= 0).all() and fast.sum() > 0
    volume = read_image(sim / "reconstructions" / "recon_fdk3d.mha")[0]
    assert volume.shape == (24, 24, 16) and np.isfinite(volume).all()
    # the forward projection and the RTK geometry against the JAX package's
    # of the port's scene
    jgeometry = jmc_geometry.MCGeometry.load(sim / "geometry.pkl.gz")
    fp_dir = tmp_path / "jax_fp"
    fp_dir.mkdir()
    jcli._forward_project_geometry(jgeometry, fp_dir, n_projections=N_VIEWS)
    ours = _read_projection_stack(sim / "density_fp.mha")
    want = _read_projection_stack(fp_dir / "density_fp.mha")
    assert ours.shape == want.shape == (N_VIEWS, 32, 64) and want.max() > 0
    np.testing.assert_allclose(ours, want, rtol=0, atol=FP_TOL * float(want.max()))
    assert (sim / "geometry.xml").read_bytes() == (fp_dir / "geometry.xml").read_bytes()
    assert (sim / "geometry.xml").read_bytes() == (theirs / "geometry.xml").read_bytes()


def test_forward_projection_4d_matches_jax(tmp_path, monkeypatch):
    """The 4D run's artifacts (the JAX package's MCSimulation4D with its
    scanner stubbed, as tests/test_pipeline.py sets it up), projected by
    each package's ``_forward_project_geometry_4d``."""
    (mats, dens), kw, config = _tiny_setup(n_projections=6)
    monkeypatch.setattr(jsimulation, "MCScanner", _StubScanner)
    fields, signals = _model(mats.shape)
    sim4d = jsimulation.MCSimulation4D(
        correspondence_model=jcorrespondence.CorrespondenceModel().fit(fields, signals),
        geometry=jmc_geometry.MCGeometry(mats, dens, image_spacing=(8.0,) * 3),
        parameters=jsimulate.SimulationParameters(**kw), n_pixels_half_fan_x=24,
        air_n_histories=20_000)
    sim4d.run_simulation(jrespiratory.RespiratorySignal.create_sin4(total_seconds=0.5,
                                                                    period=0.5),
                         tmp_path, respiratory_signal_quantization=3,
                         air_projection_denoise_kernel_size=(2.0, 2.0))
    panel = dict(n_pixels_u=24, n_pixels_v=16, pixel_size_u=16.0, pixel_size_v=16.0,
                 detector_offset_u=0.0)
    cli._forward_project_geometry_4d(tmp_path, n_projections=6,
                                     recon_geometry=recon_geometry.ConeBeamGeometry(**panel),
                                     device="cpu")
    ours = _read_projection_stack(tmp_path / "density_fp_4d.mha")
    jcli._forward_project_geometry_4d(tmp_path, n_projections=6,
                                      recon_geometry=jrecon_geometry.ConeBeamGeometry(**panel))
    want = _read_projection_stack(tmp_path / "density_fp_4d.mha")
    assert ours.shape == want.shape == (6, 16, 24)
    assert (want.sum(axis=(1, 2)) > 0).all()
    np.testing.assert_allclose(ours, want, rtol=0, atol=FP_TOL * float(want.max()))
    with pytest.raises(ValueError, match="expected 5"):
        cli._forward_project_geometry_4d(tmp_path, n_projections=5, device="cpu")


def test_run_mc_4d_branch_writes_the_jax_files(toy_size, tmp_path):
    """The 4D branch from a geometry file with a correspondence model and a
    signal, the forward projection of the warped states and the speedup."""
    (mats, dens), _, _ = _tiny_setup()
    fields, signals = _model(mats.shape)
    geometry = tmp_path / "scene.pkl.gz"
    MCGeometry(mats, dens, image_spacing=(8.0,) * 3).save(geometry)
    model = jcorrespondence.CorrespondenceModel().fit(fields, signals).save(tmp_path / "model.pkl")
    signal = tmp_path / "signal.pkl"
    jrespiratory.RespiratorySignal.create_sin4(total_seconds=0.5, period=0.5).save(signal)
    options = dict(geometry_filepath=geometry, speedups=(10.0,), reference_n_histories=200_000,
                   n_projections=4, do_forward_projection=True, air_n_histories=20_000.0,
                   n_lanes=4096, correspondence_model=model, respiratory_signal=signal,
                   respiratory_signal_quantization=3, respiratory_signal_scaling=0.5,
                   reconstruct_4d=False)
    folder = cli.run_mc(tmp_path / "ours", device="cpu", **options)
    _jax_run_mc(output_folder=tmp_path / "theirs", **options)
    sim = folder / "speedup_10.00x"
    theirs = tmp_path / "theirs" / "scene" / "speedup_10.00x"
    assert _names(sim) == _names(theirs)
    for name in ("density_fp_4d.mha", "projections_total_speedup.mha",
                 "projection_geometries.yaml", "signal.txt"):
        assert (sim / name).is_file(), name
    for name in ("projection_geometries.yaml", "signal.txt", "signal_quantized.txt"):
        assert (sim / name).read_bytes() == (theirs / name).read_bytes(), name
    fast = _read_projection_stack(sim / "projections_total_speedup.mha")
    assert fast.shape == (4, 32, 64) and np.isfinite(fast).all()


def _stack(tmp_path, n=8):
    rng = np.random.default_rng(11)
    proj = rng.random((n, 32, 48)).astype(np.float32)
    path = tmp_path / "projections_total_normalized.mha"
    jwrite_image(np.transpose(proj, (2, 1, 0)), path, spacing=(8.0, 8.0, 1.0))
    return path


def test_recon_mc_fdk3d_matches_jax(tmp_path):
    path = _stack(tmp_path)
    options = dict(dimension=(24, 12, 20), spacing=(6.0, 6.0, 6.0), n_projections=8,
                   pad=0.5, hann=0.8, hann_y=0.9, wpc=True)
    out = cli.recon_mc(path, output_folder=tmp_path / "ours", device="cpu", **options)
    assert out == tmp_path / "ours" / "recon_fdk3d.mha"
    args = ["--projections-filepath", str(path), "--output-folder", str(tmp_path / "theirs"),
            "--dimension", "24", "12", "20", "--spacing", "6", "6", "6", "--n-projections", "8",
            "--pad", "0.5", "--hann", "0.8", "--hann-y", "0.9", "--wpc"]
    result = CliRunner().invoke(jcli.recon_mc, args, catch_exceptions=False)
    assert result.exit_code == 0, result.output
    ours, meta = read_image(out)
    want, jmeta = jread_image(tmp_path / "theirs" / "recon_fdk3d.mha")
    assert ours.shape == want.shape == (20, 24, 12)
    np.testing.assert_array_equal(meta["spacing"], jmeta["spacing"])
    np.testing.assert_allclose(ours, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))
    assert (tmp_path / "ours" / "recon_fdk3d.yaml").read_text().replace(
        str(tmp_path), "") == (tmp_path / "theirs" / "recon_fdk3d.yaml").read_text().replace(
        str(tmp_path), "")


def test_recon_mc_rooster4d_passes_its_options(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(reconstruction, "reconstruct_4d",
                        lambda path, **kw: calls.append((path, kw)) or path)
    signal = tmp_path / "signal.txt"
    np.savetxt(signal, np.stack([np.linspace(0, 1, 8), np.ones(8)]).T)
    cli.recon_mc("p.mha", method="rooster4d", amplitude_signal_filepath=signal,
                 dimension=(8, 4, 8), n_projections=8, device="cpu")
    (path, kw), = calls
    np.testing.assert_array_equal(kw.pop("amplitude_signal"), np.linspace(0, 1, 8))
    assert path == "p.mha" and kw == dict(output_folder=None, output_filename=None,
                                          dimension=(8, 4, 8), spacing=(1.0, 1.0, 1.0),
                                          use_wpc=False, n_projections=8, device="cpu")


def _recorder(calls, result):
    def record(**kwargs):
        calls.append(kwargs)
        return result
    return record


@pytest.mark.parametrize("command", ["fit-noise", "run-mc-lp"])
def test_validation_commands_pass_their_options(command, tmp_path, monkeypatch):
    """The port's command and plain function hand the workflow what the JAX
    package's command hands its own (with the device), and print its
    result."""
    ours, theirs = [], []
    if command == "fit-noise":
        targets = [(noise_fit, "run_noise_fit", ours), (jnoise_fit, "run_noise_fit", theirs)]
        args = ["--n-histories-start", "2e6", "--n-runs", "3", "--n-projections", "5",
                "--shape", "8", "8", "8", "--detector-binning", "2"]
        plain = functools.partial(cli.fit_noise, n_histories_start=2e6, n_runs=3,
                                  n_projections=5, shape=(8, 8, 8), detector_binning=2)
    else:
        targets = [(mtf_workflow, "run_line_pair_simulations", ours),
                   (jmtf_workflow, "run_line_pair_simulations", theirs)]
        args = ["--line-gaps", "2", "--line-gaps", "3.5", "--n-histories", "3e6",
                "--n-projections", "7", "--detector-binning", "4"]
        plain = functools.partial(cli.run_mc_lp, line_gaps=(2.0, 3.5), n_histories=3e6,
                                  n_projections=7, detector_binning=4)
    for module, name, calls in targets:
        monkeypatch.setattr(module, name, _recorder(calls, {"best": 1.5}))
    args = ["--output-folder", str(tmp_path), *args]
    result = CliRunner().invoke(cli.main, [command, *args], catch_exceptions=False)
    assert result.exit_code == 0 and json.loads(result.output) == {"best": 1.5}
    jcommand = {"fit-noise": jcli.fit_noise, "run-mc-lp": jcli.run_mc_lp}[command]
    assert CliRunner().invoke(jcommand, args, catch_exceptions=False).exit_code == 0
    assert plain(tmp_path, device="cpu") == {"best": 1.5}
    assert ours[0] == {**theirs[0], "device": None}
    assert ours[1] == {**theirs[0], "device": "cpu"}


@pytest.mark.parametrize("command", [None, "run-mc", "recon-mc", "fit-noise", "run-mc-lp"])
def test_help(command):
    args = [command, "--help"] if command else ["--help"]
    result = CliRunner().invoke(cli.main, args)
    assert result.exit_code == 0 and "Usage:" in result.output
    if command:
        jcommand = {"run-mc": jcli.run_mc, "recon-mc": jcli.recon_mc,
                    "fit-noise": jcli.fit_noise, "run-mc-lp": jcli.run_mc_lp}[command]
        theirs = {p.name for p in jcommand.params}
        assert {p.name for p in cli.main.commands[command].params} == theirs


def test_run_mc_without_a_geometry_is_a_usage_error(tmp_path):
    result = CliRunner().invoke(cli.main, ["run-mc", "--output-folder", str(tmp_path)])
    assert result.exit_code == 2
    assert "Provide --image-filepath, --geometry-filepath or a phantom flag" in result.output
    assert list(tmp_path.iterdir()) == []


def test_gpu_takes_one_index(tmp_path):
    result = CliRunner().invoke(cli.main, ["run-mc", "--output-folder", str(tmp_path),
                                           "--cirs-phantom", "--gpu", "0", "--gpu", "1"])
    assert result.exit_code == 2 and "--gpu 0 --gpu 1" in result.output
    assert cli._gpu_device((3,)) == "cuda:3"


def test_run_mc_dry_run_writes_nothing(tmp_path):
    (mats, dens), _, _ = _tiny_setup()
    geometry = tmp_path / "scene.pkl.gz"
    MCGeometry(mats, dens, image_spacing=(8.0,) * 3).save(geometry)
    out = tmp_path / "out"
    folder = cli.run_mc(out, geometry_filepath=geometry, reference_sim=True, speedups=(5.0,),
                        dry_run=True, no_clean=True, device="cpu")
    assert folder == out / "scene" and not out.exists()
