"""Command-line interface of the port: ``python -m cbctmc_tpu_torch.cli``.

The port of the JAX package's ``cli.py``, which mirrors the reference's
entry points and option surface (reference: scripts/run_mc_simulations.py
``run-mc``, cbctmc/reconstruction/reconstruction.py ``recon-mc``,
scripts/fit_noise.py ``fit-noise``, scripts/run_mc_line_pairs.py
``run-mc-lp``). Each click command is a thin wrapper over a plain function
of the same name that takes ``device=`` (``cuda`` unless the caller passes
``"cpu"``) and does the work. ``--gpu`` selects the card ``cuda:<index>``,
its meaning in the reference; the port runs on one card, so more than one
index is refused.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Optional, Sequence, Tuple

import click
import numpy as np

logger = logging.getLogger(__name__)

ASSET_MODELS = Path(__file__).parent / "assets" / "models"


def _init_logging(loglevel: str):
    logging.basicConfig(
        level=getattr(logging, loglevel.upper()),
        format="%(asctime)s %(levelname)-7s %(name)s: %(message)s",
    )


def _load_geometry(
    image_filepath: Optional[Path],
    geometry_filepath: Optional[Path],
    segmenter_weights: Optional[Path],
    segmenter_patch_shape: Tuple[int, int, int],
    segmenter_patch_overlap: float,
    cirs_phantom: bool,
    catphan_phantom: bool,
    device,
):
    from cbctmc_tpu_torch.geometry.mc_geometry import MCGeometry
    from cbctmc_tpu_torch.geometry.phantoms import CatPhan604Geometry

    if catphan_phantom:
        logger.info("Using built-in CatPhan604 phantom geometry")
        return CatPhan604Geometry(shape=(500, 500, 500))
    if cirs_phantom:
        from cbctmc_tpu_torch.geometry.phantoms import CIRSPhantomGeometry

        logger.info(
            "Using built-in CIRS thorax phantom with the motion insert"
        )
        return CIRSPhantomGeometry.synthetic_thorax().place_insert()
    if geometry_filepath:
        return MCGeometry.load(geometry_filepath)
    from cbctmc_tpu_torch.pipeline.patient import geometry_from_ct

    return geometry_from_ct(
        image_filepath,
        segmenter_weights=segmenter_weights,
        patch_shape=segmenter_patch_shape,
        patch_overlap=segmenter_patch_overlap,
        device=device,
    )


def _default_weights(name: str, current: Optional[Path]) -> Optional[Path]:
    """The packaged weights of ``name`` when none are given, but only when
    the asset carries a passing holdout-eval stamp (default.eval.json; the
    reference defaults to its assets/models/{segmenter,speedup}/default
    weights); weights without a recorded quality metric must be passed
    explicitly."""
    from cbctmc_tpu_torch.models.checkpoints import asset_has_passing_stamp

    if current is not None:
        return current
    asset_dir = ASSET_MODELS / name
    if asset_has_passing_stamp(asset_dir):
        return asset_dir / "default.ckpt"
    if (asset_dir / "default.ckpt").is_file():
        logger.warning(
            "packaged %s weights exist but carry no passing quality "
            "stamp (default.eval.json); not using them as a default — "
            "pass --%s-weights explicitly to override",
            name, name.replace("_", "-"),
        )
    return None


def run_mc(
    output_folder,
    image_filepath=None,
    geometry_filepath=None,
    simulation_name: Optional[str] = None,
    reference_sim: bool = False,
    reference_n_histories: int = 11_903_320_312,
    speedups: Sequence[float] = (),
    speedup_weights=None,
    segmenter_weights=None,
    segmenter_patch_shape: Tuple[int, int, int] = (256, 256, 128),
    segmenter_patch_overlap: float = 0.5,
    n_projections: int = 894,
    reconstruct_3d: bool = False,
    reconstruct_4d: bool = False,
    do_forward_projection: bool = False,
    no_clean: bool = False,
    correspondence_model=None,
    respiratory_signal=None,
    respiratory_signal_quantization: Optional[int] = None,
    respiratory_signal_scaling: float = 1.0,
    precompile_geometries: bool = False,
    cirs_phantom: bool = False,
    catphan_phantom: bool = False,
    dry_run: bool = False,
    random_seed: int = 42,
    air_n_histories: Optional[float] = None,
    n_lanes: Optional[int] = None,
    device=None,
) -> Path:
    """Run 3D/4D Monte-Carlo CBCT simulation (the reference's ``run-mc``) on
    ``device``; returns the simulation's folder. From a CT image the scene is
    segmented, mapped to materials and simulated, the speedup net applied to
    the ``speedup_*`` configurations; the 4D branch runs when both a
    correspondence model and a respiratory signal are given."""
    from cbctmc_tpu_torch.engine.device import resolve_device
    from cbctmc_tpu_torch.engine.simulate import SimulationParameters
    from cbctmc_tpu_torch.engine.transport import production_engine_config
    from cbctmc_tpu_torch.pipeline.simulation import MCSimulation, MCSimulation4D

    if not (image_filepath or geometry_filepath or cirs_phantom or catphan_phantom):
        raise click.UsageError(
            "Provide --image-filepath, --geometry-filepath or a phantom flag"
        )
    dev = resolve_device(device)
    output_folder = Path(output_folder)

    if no_clean:
        logger.warning(
            "--no-clean has no effect: the in-process engine produces no "
            "per-projection temp files to clean (the reference flag kept "
            "MC-GPU's ASCII projection files)"
        )

    if simulation_name is None:
        source_path = image_filepath or geometry_filepath
        simulation_name = (
            Path(source_path).stem.split(".")[0] if source_path else "phantom"
        )
    output_folder = output_folder / simulation_name

    segmenter_weights = _default_weights("segmenter", segmenter_weights)
    speedup_weights = _default_weights("speedup", speedup_weights)

    geometry = _load_geometry(
        image_filepath, geometry_filepath, segmenter_weights,
        segmenter_patch_shape, segmenter_patch_overlap,
        cirs_phantom, catphan_phantom, dev,
    )

    # configs: reference + speedup_N with n_histories / N
    configs = {}
    if reference_sim:
        configs["reference"] = reference_n_histories
    for factor in speedups:
        configs[f"speedup_{factor:.2f}x"] = int(reference_n_histories / factor)
    if not configs:
        configs["reference"] = reference_n_histories

    engine_config = production_engine_config(
        **({'n_lanes': n_lanes} if n_lanes else {}))
    is_4d = correspondence_model is not None and respiratory_signal is not None

    for config_name, n_histories in configs.items():
        params = SimulationParameters(
            n_histories=n_histories,
            n_projections=n_projections,
            angle_between_projections=360.0 / n_projections,
            random_seed=random_seed,
        )
        sim_folder = output_folder / config_name
        logger.info("Running simulation %s (%.3e histories)", config_name, n_histories)
        if dry_run:
            logger.info("Dry run: skipping simulation %s", config_name)
            continue

        if is_4d:
            from cbctmc_tpu_torch.pipeline.correspondence import CorrespondenceModel
            from cbctmc_tpu_torch.pipeline.respiratory import RespiratorySignal

            model = CorrespondenceModel.load(correspondence_model)
            signal = RespiratorySignal.load(respiratory_signal)
            if respiratory_signal_scaling != 1.0:
                signal = RespiratorySignal(
                    signal.signal * respiratory_signal_scaling,
                    signal.dt_signal * respiratory_signal_scaling,
                    signal.sampling_frequency,
                )
            sim4d = MCSimulation4D(
                correspondence_model=model,
                geometry=geometry,
                parameters=params,
                engine_config=engine_config,
                **({"air_n_histories": int(air_n_histories)}
                   if air_n_histories else {}),
                device=dev,
            )
            # --precompile-geometries is not passed on: the JAX package's
            # run-mc accepts the flag and leaves it unused, as here
            sim4d.run_simulation(
                respiratory_signal=signal,
                respiratory_signal_quantization=respiratory_signal_quantization,
                output_folder=sim_folder,
            )
        else:
            sim = MCSimulation(
                geometry=geometry, parameters=params,
                engine_config=engine_config,
                **({"air_n_histories": int(air_n_histories)}
                   if air_n_histories else {}),
                device=dev,
            )
            sim.run_simulation(sim_folder, seed=random_seed)

        if do_forward_projection:
            if is_4d:
                _forward_project_geometry_4d(
                    sim_folder, n_projections=n_projections, device=dev
                )
            else:
                _forward_project_geometry(
                    geometry, sim_folder, n_projections=n_projections, device=dev
                )

        # the reference applies the speedup net to the speedup_* runs only
        if speedup_weights and config_name.startswith("speedup"):
            fp_name = "density_fp_4d.mha" if is_4d else "density_fp.mha"
            _apply_speedup(
                sim_folder, speedup_weights,
                forward_projection_path=(
                    sim_folder / fp_name if do_forward_projection else None
                ),
                device=dev,
            )

        if reconstruct_3d:
            _reconstruct_3d_cli(
                sim_folder / "projections_total_normalized.mha",
                n_projections=n_projections, device=dev,
            )
        # as in the reference, --reconstruct-4d acts in the 4D branch only
        if reconstruct_4d and is_4d:
            _reconstruct_4d_cli(
                sim_folder / "projections_total_normalized.mha",
                sim_folder / "signal.txt",
                n_projections=n_projections, device=dev,
            )
    return output_folder


def _forward_project_geometry(geometry, sim_folder: Path, n_projections: int, device=None):
    """Joseph forward projection of the density volume at the scan angles
    (the speedup model's second input; reference:
    scripts/run_mc_simulations.py:444-461 -> density_fp.mha), and the RTK
    geometry of the scan beside it."""
    from cbctmc_tpu_torch.pipeline.simulation import _write_projection_stack
    from cbctmc_tpu_torch.recon.geometry import ConeBeamGeometry, mc_scan_angles
    from cbctmc_tpu_torch.recon.joseph import project_forward
    from cbctmc_tpu_torch.recon.rtk_interop import (
        create_rtk_geometry,
        save_rtk_geometry_xml,
    )

    # the reference's orientation, kept as it is: the volume turned by
    # rot90(k=3) in (x, y) with the spacing's x and y swapped, and the
    # projections' rows flipped
    densities = np.rot90(geometry.densities, k=3, axes=(0, 1))
    spacing = (
        geometry.image_spacing[1],
        geometry.image_spacing[0],
        geometry.image_spacing[2],
    )
    fp = project_forward(
        np.ascontiguousarray(densities),
        ConeBeamGeometry(),
        mc_scan_angles(n_projections),
        volume_spacing=spacing,
        device=device,
    )
    _write_projection_stack(
        fp[:, ::-1, :], sim_folder / "density_fp.mha", (0.388, 0.388)
    )
    # RTK-compatible geometry export for cross-validation against an RTK
    # install (reference: run_mc_simulations.py:442-443 writes geometry.xml
    # next to the outputs; run-mc uses start_angle=90, kept as it is)
    save_rtk_geometry_xml(
        create_rtk_geometry(n_projections, start_angle=90.0),
        sim_folder / "geometry.xml",
    )


def _forward_project_geometry_4d(sim_folder: Path, n_projections: int,
                                 recon_geometry=None, device=None):
    """Per-angle forward projection of the WARPED geometries of a 4D run:
    each projection's density is forward-projected with the motion state the
    MC simulation used for that angle (reference:
    scripts/run_mc_simulations.py:491-556 -> density_fp_4d.mha). The warped
    geometries are read back from the 4D run's geometry cache via
    projection_geometries.yaml."""
    import yaml

    from cbctmc_tpu_torch.geometry.mc_geometry import MCGeometry
    from cbctmc_tpu_torch.pipeline.simulation import _write_projection_stack
    from cbctmc_tpu_torch.recon.geometry import ConeBeamGeometry, mc_scan_angles
    from cbctmc_tpu_torch.recon.joseph import project_forward

    with open(sim_folder / "projection_geometries.yaml") as f:
        projection_geometries = yaml.safe_load(f)
    entries = sorted(projection_geometries.items())  # angle-ordered
    if len(entries) != n_projections:
        raise ValueError(
            f"projection_geometries.yaml has {len(entries)} entries, "
            f"expected {n_projections}"
        )
    angles = mc_scan_angles(n_projections)

    # group projection indices by warped-geometry file: each unique motion
    # state is loaded and projected once
    groups: dict = {}
    for idx, (_, entry) in enumerate(entries):
        groups.setdefault(entry["geometry_filename"], []).append(idx)

    fp = None
    for geometry_filename, indices in groups.items():
        warped = MCGeometry.load(sim_folder / geometry_filename)
        # the reference's orientation, as in _forward_project_geometry
        densities = np.rot90(warped.densities, k=3, axes=(0, 1))
        spacing = (
            warped.image_spacing[1],
            warped.image_spacing[0],
            warped.image_spacing[2],
        )
        group_fp = project_forward(
            np.ascontiguousarray(densities),
            recon_geometry or ConeBeamGeometry(),
            angles[indices],
            volume_spacing=spacing,
            device=device,
        )
        if fp is None:
            fp = np.zeros((n_projections, *group_fp.shape[1:]), np.float32)
        fp[indices] = group_fp
    _write_projection_stack(
        fp[:, ::-1, :], sim_folder / "density_fp_4d.mha", (0.388, 0.388)
    )


def _apply_speedup(sim_folder: Path, speedup_weights: Path,
                   forward_projection_path: Path | None = None, device=None):
    from cbctmc_tpu_torch.models.speedup_inference import MCSpeedup
    from cbctmc_tpu_torch.pipeline.simulation import (
        _read_projection_stack,
        _write_projection_stack,
    )

    low = _read_projection_stack(sim_folder / "projections_total.mha")
    fp = None
    if forward_projection_path and Path(forward_projection_path).is_file():
        fp = _read_projection_stack(forward_projection_path)
    speedup = MCSpeedup.from_checkpoint(speedup_weights, device=device)
    mean, variance, sample = speedup.execute(low, forward_projection=fp)
    _write_projection_stack(
        sample, sim_folder / "projections_total_speedup.mha", (0.388, 0.388)
    )


def _reconstruct_3d_cli(projections_filepath: Path, n_projections: int, device=None):
    from cbctmc_tpu_torch.pipeline.reconstruction import reconstruct_3d

    reconstruct_3d(projections_filepath, n_projections=n_projections, device=device)


def _reconstruct_4d_cli(projections_filepath: Path, signal_filepath: Path,
                        n_projections: int, device=None):
    from cbctmc_tpu_torch.pipeline.reconstruction import reconstruct_4d

    amplitude = np.loadtxt(signal_filepath)[:, 0]
    reconstruct_4d(
        projections_filepath, amplitude_signal=amplitude, n_projections=n_projections,
        device=device,
    )


def recon_mc(projections_filepath, method: str = "fdk3d", output_folder=None,
             output_filename: Optional[str] = None,
             dimension: Tuple[int, int, int] = (464, 250, 464),
             spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0), pad: float = 1.0,
             hann: float = 1.0, hann_y: float = 1.0, wpc: bool = False,
             n_projections: int = 894, amplitude_signal_filepath=None, device=None) -> Path:
    """Reconstruct projections (the reference's ``recon-mc``) on ``device``;
    returns the volume's path."""
    from cbctmc_tpu_torch.pipeline.reconstruction import reconstruct_3d, reconstruct_4d

    if method == "fdk3d":
        return reconstruct_3d(
            projections_filepath, output_folder=output_folder,
            output_filename=output_filename, dimension=dimension,
            spacing=spacing, pad=pad, hann=hann, hann_y=hann_y,
            use_wpc=wpc, n_projections=n_projections, device=device,
        )
    amplitude = np.loadtxt(amplitude_signal_filepath)
    if amplitude.ndim > 1:
        amplitude = amplitude[:, 0]
    return reconstruct_4d(
        projections_filepath, amplitude_signal=amplitude,
        output_folder=output_folder, output_filename=output_filename,
        dimension=dimension, spacing=spacing, use_wpc=wpc,
        n_projections=n_projections, device=device,
    )


def fit_noise(output_folder, n_histories_start: float = 1e9, n_runs: int = 10,
              n_projections: int = 894, shape: Tuple[int, int, int] = (500, 500, 150),
              detector_binning: int = 1, device=None) -> dict:
    """Fit n_histories to match the measured Varian noise level (the
    reference's ``fit-noise``) on ``device``."""
    from cbctmc_tpu_torch.pipeline.noise_fit import run_noise_fit

    return run_noise_fit(
        output_folder=Path(output_folder),
        n_histories_start=int(n_histories_start),
        n_runs=n_runs,
        n_projections=n_projections,
        phantom_shape=shape,
        detector_binning=detector_binning,
        device=device,
    )


def run_mc_lp(output_folder, line_gaps: Sequence[float] = (1.0, 2.0, 3.0, 4.0),
              n_histories: float = 1e9, n_projections: int = 894,
              detector_binning: int = 2, device=None) -> dict:
    """Line-pair phantom MTF workflow (the reference's ``run-mc-lp``) on
    ``device``."""
    from cbctmc_tpu_torch.pipeline.mtf_workflow import run_line_pair_simulations

    return run_line_pair_simulations(
        output_folder=Path(output_folder),
        line_gaps=line_gaps,
        n_histories=int(n_histories),
        n_projections=n_projections,
        detector_binning=detector_binning,
        device=device,
    )


# ---------------------------------------------------------------------------
# click commands
# ---------------------------------------------------------------------------
_LOGLEVEL = click.option("--loglevel", type=click.Choice(
    ["debug", "info", "warning", "error", "critical"]), default="info")


def _gpu_device(gpu: Tuple[int, ...]) -> str:
    """``--gpu`` as the device: the card of the one index given. The JAX
    CLI ignores ``--gpu`` and never shards a run; a run over several cards
    is ``cbctmc_tpu_torch.parallel`` under ``torchrun``, not this option."""
    if len(gpu) != 1:
        raise click.UsageError(
            f"--gpu {' --gpu '.join(map(str, gpu))}: a command runs on one card; to "
            "shard a run over several, launch cbctmc_tpu_torch.parallel's "
            "run_projection_sharded / run_scan_sharded under torchrun"
        )
    return f"cuda:{gpu[0]}"


@click.command()
@click.option("--image-filepath", type=click.Path(path_type=Path), default=None,
              help="CT image to use for simulation")
@click.option("--geometry-filepath", type=click.Path(path_type=Path), default=None,
              help="Geometry to use instead of a CT image")
@click.option("--output-folder", type=click.Path(path_type=Path), required=True)
@click.option("--simulation-name", type=str, default=None)
@click.option("--gpu", type=int, multiple=True, default=(0,),
              help="Index of the CUDA card to run on (one)")
@click.option("--reference", "reference_sim", is_flag=True,
              help="Enable reference (full-histories) simulation")
@click.option("--reference-n-histories", type=int, default=11_903_320_312)
@click.option("--speedups", type=float, multiple=True, default=())
@click.option("--speedup-weights", type=click.Path(path_type=Path), default=None)
@click.option("--segmenter-weights", type=click.Path(path_type=Path), default=None)
@click.option("--segmenter-patch-shape", type=(int, int, int), default=(256, 256, 128))
@click.option("--segmenter-patch-overlap", type=float, default=0.5)
@click.option("--n-projections", type=int, default=894)
@click.option("--reconstruct-3d", is_flag=True)
@click.option("--reconstruct-4d", is_flag=True)
@click.option("--forward-projection", "do_forward_projection", is_flag=True)
@click.option("--no-clean", is_flag=True)
@click.option("--correspondence-model", type=click.Path(path_type=Path), default=None)
@click.option("--respiratory-signal", type=click.Path(path_type=Path), default=None)
@click.option("--respiratory-signal-quantization", type=int, default=None)
@click.option("--respiratory-signal-scaling", type=float, default=1.0)
@click.option("--precompile-geometries", is_flag=True)
@click.option("--cirs-phantom", is_flag=True)
@click.option("--catphan-phantom", is_flag=True)
@click.option("--dry-run", is_flag=True)
@click.option("--random-seed", type=int, default=42)
@click.option("--air-n-histories", type=float, default=None,
              help="Flat-field air-scan histories (default 5e10, the "
                   "reference's air budget; reduced runs can lower it)")
@click.option("--n-lanes", type=int, default=None,
              help="Photon lanes per device (default: the recorded sweep-winner engine config)")
@_LOGLEVEL
def run_mc_command(gpu, loglevel, **options):
    """Run 3D/4D Monte-Carlo CBCT simulation (the reference's ``run-mc``)."""
    device = _gpu_device(gpu)
    _init_logging(loglevel)
    run_mc(device=device, **options)


@click.command()
@click.option("--projections-filepath", type=click.Path(path_type=Path), required=True)
@click.option("--method", type=click.Choice(["fdk3d", "rooster4d"]), default="fdk3d")
@click.option("--output-folder", type=click.Path(path_type=Path), default=None)
@click.option("--output-filename", type=str, default=None)
@click.option("--dimension", type=(int, int, int), default=(464, 250, 464))
@click.option("--spacing", type=(float, float, float), default=(1.0, 1.0, 1.0))
@click.option("--pad", type=float, default=1.0)
@click.option("--hann", type=float, default=1.0)
@click.option("--hann-y", type=float, default=1.0)
@click.option("--wpc", is_flag=True, help="Apply the default water precorrection")
@click.option("--n-projections", type=int, default=894)
@click.option("--amplitude-signal-filepath", type=click.Path(path_type=Path),
              default=None)
@_LOGLEVEL
def recon_mc_command(loglevel, **options):
    """Reconstruct projections (the reference's ``recon-mc``)."""
    _init_logging(loglevel)
    recon_mc(**options)


@click.command()
@click.option("--output-folder", type=click.Path(path_type=Path), required=True)
@click.option("--n-histories-start", type=float, default=1e9)
@click.option("--n-runs", type=int, default=10)
@click.option("--n-projections", type=int, default=894)
@click.option("--shape", type=(int, int, int), default=(500, 500, 150))
@click.option("--detector-binning", type=int, default=1,
              help="average-pool the detector before normalisation; the "
                   "fit grid (photons/pixel recorded per sample)")
@_LOGLEVEL
def fit_noise_command(loglevel, **options):
    """Fit n_histories to match the measured Varian noise level
    (the reference's ``fit-noise``)."""
    _init_logging(loglevel)
    click.echo(json.dumps(fit_noise(**options), indent=2))


@click.command()
@click.option("--output-folder", type=click.Path(path_type=Path), required=True)
@click.option("--line-gaps", type=float, multiple=True, default=(1.0, 2.0, 3.0, 4.0))
@click.option("--n-histories", type=float, default=1e9)
@click.option("--n-projections", type=int, default=894)
@click.option("--detector-binning", type=int, default=2)
@_LOGLEVEL
def run_mc_lp_command(loglevel, **options):
    """Line-pair phantom MTF workflow (the reference's ``run-mc-lp``)."""
    _init_logging(loglevel)
    click.echo(json.dumps(run_mc_lp(**options), indent=2))


@click.group()
def main():
    """cbctmc-tpu, the PyTorch/CUDA port: 4D CBCT Monte-Carlo simulation on
    an NVIDIA card."""


main.add_command(run_mc_command, "run-mc")
main.add_command(recon_mc_command, "recon-mc")
main.add_command(fit_noise_command, "fit-noise")
main.add_command(run_mc_lp_command, "run-mc-lp")


if __name__ == "__main__":
    main()
