"""Scan-level simulation orchestration with artifact-level idempotence: the
``run-mc`` layer. The port's copy of the JAX package's
``pipeline/simulation.py``; the engine runs on ``device`` (``cuda`` unless
the caller passes ``"cpu"``).

The reference's MCSimulation / MCSimulation4D (cbctmc/mc/simulation.py),
with the same artifact layout so downstream tooling keeps working (the
``recon-mc`` entry points read it) —

- ``projections_total.mha`` / ``projections_unscattered.mha`` /
  ``projections_scattered.mha``: half-fan-cropped projection stacks,
- ``air/projections_total.mha``: flat-field scan of a huge air voxel,
- ``projections_total_normalized.mha``: Beer-Lambert air-normalised stack,
- ``geometry_materials.nii.gz`` / ``geometry_densities.nii.gz`` /
  ``geometry.pkl.gz``: the simulated scene,
- 4D: per-motion-state geometries cached by signal hash, a
  ``projection_geometries.yaml`` bookkeeping file, ``signal.txt`` /
  ``signal_quantized.txt``.

Differences by design: no Docker/MPI process boundary (the engine is an
in-process PyTorch program), no ASCII .vox/.in round trip, and no
first-angle-duplication workaround (the reference duplicates each group's
first projection angle to dodge an MC-GPU projection-0 direction bug,
mc/simulation.py:658-660; this engine builds every projection from its own
angle). Every motion state's scan restarts the random streams: its
``MCScanner.simulate`` runs with the parameters' seed and numbers its views
from 0, as in the JAX package, so the k-th view of every state draws the
same random words.

Each step logs its host wall at INFO: per motion state the warp, the
geometry files, the scanner's set-up and the transport; per stack its
write.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from cbctmc_tpu_torch.engine.device import resolve_device
from cbctmc_tpu_torch.engine.simulate import (
    MCScanner,
    SimulationParameters,
    air_normalize,
    crop_half_fan,
)
from cbctmc_tpu_torch.engine.transport import EngineConfig
from cbctmc_tpu_torch.geometry.mc_geometry import MCGeometry
from cbctmc_tpu_torch.geometry.phantoms import AirGeometry
from cbctmc_tpu_torch.pipeline.correspondence import CorrespondenceModel
from cbctmc_tpu_torch.pipeline.respiratory import RespiratorySignal
from cbctmc_tpu_torch.utils.io import read_image, write_image

logger = logging.getLogger(__name__)

AIR_SIMULATION_FOLDER = "air"
DEFAULT_AIR_HISTORIES = int(5e10)


def _write_projection_stack(
    images_cropped: np.ndarray, filepath: Path, pixel_size_mm: Tuple[float, float]
):
    """Write [P, v, u] as a reference-layout .mha stack: row axis flipped,
    centred origin (reference: projection.py:42-51, 159-167)."""
    stack = np.ascontiguousarray(images_cropped.astype(np.float32))
    # our arrays are [P, v, u]; disk layout wants [u, v, P] xyz
    arr_xyz = np.transpose(stack, (2, 1, 0))
    write_image(
        arr_xyz,
        filepath,
        spacing=(pixel_size_mm[0], pixel_size_mm[1], 1.0),
        origin=(
            -arr_xyz.shape[0] * pixel_size_mm[0] / 2,
            -arr_xyz.shape[1] * pixel_size_mm[1] / 2,
            0.0,
        ),
    )


def _read_projection_stack(filepath) -> np.ndarray:
    arr_xyz, _ = read_image(filepath)
    return np.transpose(arr_xyz, (2, 1, 0))


@dataclasses.dataclass
class MCSimulation:
    """3D scan simulation of one geometry, on ``device`` (``cuda`` unless
    the caller passes ``"cpu"``; without a card construction raises)."""

    geometry: MCGeometry
    parameters: SimulationParameters = dataclasses.field(
        default_factory=SimulationParameters
    )
    engine_config: EngineConfig = dataclasses.field(default_factory=EngineConfig)
    n_pixels_half_fan_x: int = 1024
    air_n_histories: int = DEFAULT_AIR_HISTORIES
    device: str | torch.device | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @staticmethod
    def already_simulated(output_folder) -> bool:
        return (Path(output_folder) / "projections_total.mha").is_file()

    # ------------------------------------------------------------------
    def run_air_simulation(
        self,
        output_folder,
        n_histories: int | None = None,
        force_rerun: bool = False,
    ) -> np.ndarray:
        """One flat-field projection of a huge air voxel
        (reference: mc/simulation.py:72-87)."""
        output_folder = Path(output_folder) / AIR_SIMULATION_FOLDER
        out = output_folder / "projections_total.mha"
        if out.is_file() and not force_rerun:
            return _read_projection_stack(out)

        logger.info("Run air simulation")
        air = AirGeometry()
        params = dataclasses.replace(
            self.parameters,
            n_histories=n_histories or self.air_n_histories,
            projection_angles=(270.0,),
        )
        scanner = MCScanner(
            air.materials, air.densities, air.image_spacing,
            parameters=params, engine_config=self.engine_config,
            device=self.device,
        )
        images, _ = scanner.simulate(progress=False)
        total = crop_half_fan(images.sum(axis=1), self.n_pixels_half_fan_x)
        _write_projection_stack(
            total, out, self._half_fan_pixel_size()
        )
        return total

    def _half_fan_pixel_size(self) -> Tuple[float, float]:
        p = self.parameters
        return (
            p.detector_size[0] / p.n_detector_pixels[0],
            p.detector_size[1] / p.n_detector_pixels[1],
        )

    # ------------------------------------------------------------------
    def run_simulation(
        self,
        output_folder,
        geometry_output_folder=None,
        output_suffix: str = "",
        run_air_simulation: bool = True,
        air_projection_denoise_kernel_size: Tuple[float, float] | None = (10.0, 10.0),
        force_rerun: bool = False,
        seed: Optional[int] = None,
        save_geometry_artifacts: bool = True,
    ) -> Dict[str, Path]:
        output_folder = Path(output_folder)
        geometry_output_folder = Path(geometry_output_folder or output_folder)
        output_folder.mkdir(parents=True, exist_ok=True)
        geometry_output_folder.mkdir(parents=True, exist_ok=True)

        if self.already_simulated(output_folder) and not force_rerun:
            logger.info(
                "Output folder %s already contains a finished simulation; "
                "skipping (force_rerun=False)", output_folder,
            )
            return {}

        if save_geometry_artifacts:
            self.geometry.save_material_segmentation(
                geometry_output_folder / f"geometry_materials{output_suffix}.nii.gz"
            )
            self.geometry.save_density_image(
                geometry_output_folder / f"geometry_densities{output_suffix}.nii.gz"
            )
            self.geometry.save(
                geometry_output_folder / f"geometry{output_suffix}.pkl.gz"
            )

        air_projection = None
        if run_air_simulation:
            air_projection = self.run_air_simulation(output_folder)

        scanner = MCScanner(
            self.geometry.materials,
            self.geometry.densities,
            self.geometry.image_spacing,
            parameters=self.parameters,
            engine_config=self.engine_config,
            device=self.device,
        )
        images, info = scanner.simulate(seed=seed)
        logger.info(
            "Simulation finished: %.3e histories at %.3e histories/s",
            info.n_histories, info.histories_per_second,
        )

        return self.write_outputs(
            images, output_folder,
            air_projection=air_projection,
            air_projection_denoise_kernel_size=air_projection_denoise_kernel_size,
            output_suffix=output_suffix,
        )

    def write_outputs(
        self,
        images: np.ndarray,  # [P, 4, v, u] eV/cm^2/history (wide detector)
        output_folder: Path,
        air_projection: Optional[np.ndarray] = None,
        air_projection_denoise_kernel_size=(10.0, 10.0),
        output_suffix: str = "",
    ) -> Dict[str, Path]:
        output_folder = Path(output_folder)
        pixel_size = self._half_fan_pixel_size()
        artifacts = {}

        total = crop_half_fan(images.sum(axis=1), self.n_pixels_half_fan_x)
        unscattered = crop_half_fan(images[:, 0], self.n_pixels_half_fan_x)
        scattered = crop_half_fan(
            images[:, 1:].sum(axis=1), self.n_pixels_half_fan_x
        )
        for name, stack in (
            ("total", total),
            ("unscattered", unscattered),
            ("scattered", scattered),
        ):
            path = output_folder / f"projections_{name}{output_suffix}.mha"
            t0 = time.monotonic()
            _write_projection_stack(stack, path, pixel_size)
            logger.info("Wrote %s in %.3f s", path.name, time.monotonic() - t0)
            artifacts[name] = path

        if air_projection is not None:
            normalized = air_normalize(
                total,
                air_projection[0],
                denoise_sigma=air_projection_denoise_kernel_size,
            )
            path = output_folder / f"projections_total_normalized{output_suffix}.mha"
            t0 = time.monotonic()
            _write_projection_stack(normalized, path, pixel_size)
            logger.info("Wrote %s in %.3f s", path.name, time.monotonic() - t0)
            artifacts["normalized"] = path
        return artifacts


@dataclasses.dataclass
class MCSimulation4D:
    """4D scan: the geometry is deformed per projection according to the
    respiratory signal through the correspondence model; projections with
    identical (quantised) motion state share one warped geometry
    (reference: mc/simulation.py:430-710). Runs on ``device`` (``cuda``
    unless the caller passes ``"cpu"``; without a card construction
    raises); one ``MCScanner`` per motion state, released before the next
    state's is built."""

    correspondence_model: CorrespondenceModel
    geometry: MCGeometry
    parameters: SimulationParameters = dataclasses.field(
        default_factory=SimulationParameters
    )
    engine_config: EngineConfig = dataclasses.field(default_factory=EngineConfig)
    frame_rate: float = 15.0
    start_angle: float = 270.0
    n_pixels_half_fan_x: int = 1024
    air_n_histories: int = DEFAULT_AIR_HISTORIES
    device: str | torch.device | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @staticmethod
    def _signal_hash(signal: float, dt_signal: float) -> str:
        return hashlib.sha256(
            np.array([signal, dt_signal], dtype=np.float32).tobytes()
        ).hexdigest()[:7]

    def _warp_geometry(self, signal: float, dt_signal: float) -> MCGeometry:
        dvf = self.correspondence_model.predict(np.array([signal, dt_signal]))
        return self.geometry.warp(dvf)

    def run_simulation(
        self,
        respiratory_signal: RespiratorySignal,
        output_folder,
        respiratory_signal_quantization: Optional[int] = None,
        geometry_output_folder=None,
        run_air_simulation: bool = True,
        air_projection_denoise_kernel_size=(10.0, 10.0),
        force_rerun: bool = False,
        precompile_geometries: bool = False,
    ) -> Dict[str, Path]:
        import yaml

        output_folder = Path(output_folder)
        geometry_output_folder = Path(geometry_output_folder or output_folder)
        output_folder.mkdir(parents=True, exist_ok=True)
        geometry_output_folder.mkdir(parents=True, exist_ok=True)

        if MCSimulation.already_simulated(output_folder) and not force_rerun:
            logger.info("4D simulation already present in %s; skipping", output_folder)
            return {}

        p = self.parameters
        # one signal sample per projection
        resampled = respiratory_signal.resample(self.frame_rate)
        signal = resampled.signal[: p.n_projections]
        dt_signal = resampled.dt_signal[: p.n_projections]
        if len(signal) < p.n_projections:
            # float jitter in total_seconds * frame_rate can leave the
            # resampled signal a sample short; edge-pad rather than lose
            # the last projection from the bookkeeping (a 71-entry
            # projection_geometries.yaml for a 72-view scan aborts the
            # 4D forward projection downstream)
            short = p.n_projections - len(signal)
            if short > 2:
                raise ValueError(
                    f"Respiratory signal covers only {len(signal)} of "
                    f"{p.n_projections} projections; provide a longer signal"
                )
            logger.warning(
                "Respiratory signal %d sample(s) short of n_projections; "
                "edge-padding", short,
            )
            signal = np.concatenate([signal, np.repeat(signal[-1], short)])
            dt_signal = np.concatenate(
                [dt_signal, np.repeat(dt_signal[-1], short)]
            )
        np.savetxt(
            output_folder / "signal.txt",
            np.stack((signal, dt_signal)).T,
            header="original respiratory signal and its derivative\nsignal dt_signal",
            fmt="%.6f",
        )

        if respiratory_signal_quantization:
            signal = RespiratorySignal.quantize_signal(
                signal, n_bins=respiratory_signal_quantization
            )
            dt_signal = RespiratorySignal.quantize_signal(
                dt_signal, n_bins=respiratory_signal_quantization
            )
        np.savetxt(
            output_folder / "signal_quantized.txt",
            np.stack((signal, dt_signal)).T,
            header=(
                "quantized respiratory signal and its derivative\n"
                f"signal quantization: {respiratory_signal_quantization} bins\n"
                "signal dt_signal"
            ),
            fmt="%.6f",
        )

        unique_signals = RespiratorySignal.get_unique_signals(signal, dt_signal)
        logger.info("Unique motion states: %d", len(unique_signals))

        if precompile_geometries:
            # warp and cache every unique motion state up front with a small
            # thread pool (reference: mc/simulation.py:506-525)
            from multiprocessing.pool import ThreadPool

            def _prepare(item):
                (s_val, ds_val) = item
                suffix = f"_{self._signal_hash(s_val, ds_val)}"
                geometry_file = (
                    geometry_output_folder / f"geometry{suffix}.pkl.gz"
                )
                if not geometry_file.is_file():
                    self._warp_geometry(s_val, ds_val).save(geometry_file)

            with ThreadPool(8) as pool:
                pool.map(_prepare, list(unique_signals.keys()))
            logger.info("Precompiled %d warped geometries", len(unique_signals))

        base_sim = MCSimulation(
            geometry=self.geometry,
            parameters=p,
            engine_config=self.engine_config,
            n_pixels_half_fan_x=self.n_pixels_half_fan_x,
            air_n_histories=self.air_n_histories,
            device=self.device,
        )
        air_projection = (
            base_sim.run_air_simulation(output_folder) if run_air_simulation else None
        )

        n_wide = p.n_detector_pixels
        all_images = np.zeros(
            (p.n_projections, 4, n_wide[1], n_wide[0]), np.float64
        )
        projection_geometries = {}

        for (s, ds), indices in unique_signals.items():
            suffix = f"_{self._signal_hash(s, ds)}"
            geometry_file = geometry_output_folder / f"geometry{suffix}.pkl.gz"
            t0 = time.monotonic()
            if geometry_file.is_file():
                warped = MCGeometry.load(geometry_file)
                t1 = time.monotonic()
            else:
                warped = self._warp_geometry(s, ds)
                t1 = time.monotonic()
                warped.save(geometry_file)
                warped.save_material_segmentation(
                    geometry_output_folder / f"geometry_materials{suffix}.nii.gz"
                )
                warped.save_density_image(
                    geometry_output_folder / f"geometry_densities{suffix}.nii.gz"
                )

            angles = [
                self.start_angle + i * p.angle_between_projections for i in indices
            ]
            for angle in angles:
                projection_geometries[float(angle)] = {
                    "signal": float(s),
                    "dt_signal": float(ds),
                    "signal_quantization": respiratory_signal_quantization,
                    "hash": suffix[1:],
                    "geometry_filename": geometry_file.name,
                }

            t2 = time.monotonic()
            scanner = MCScanner(
                warped.materials, warped.densities, warped.image_spacing,
                parameters=p, engine_config=self.engine_config,
                device=self.device,
            )
            t3 = time.monotonic()
            images, _ = scanner.simulate(angles_deg=angles, progress=False)
            del scanner  # its workspace goes before the next state's is built
            all_images[indices] = images
            t4 = time.monotonic()
            logger.info(
                "Simulated %d projections for motion state (%.4f, %.4f): "
                "warp %.3f s, geometry files %.3f s, scanner set-up %.3f s, "
                "transport %.3f s",
                len(indices), s, ds, t1 - t0, t2 - t1, t3 - t2, t4 - t3,
            )

        with open(output_folder / "projection_geometries.yaml", "wt") as f:
            yaml.dump(dict(sorted(projection_geometries.items())), f)

        return base_sim.write_outputs(
            all_images, output_folder,
            air_projection=air_projection,
            air_projection_denoise_kernel_size=air_projection_denoise_kernel_size,
        )
