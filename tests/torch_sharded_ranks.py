"""The rank side of tests/test_torch_sharded.py: what each process of a
gloo world on the CPU runs. It imports no JAX, because a spawned process
imports this module anew.

A world is started by :func:`run_world`: ``world`` processes (spawned), each
joining the process group through a file store in ``folder``, running one
task on the inputs the parent saved there and saving its result beside
them; a rank that fails leaves its traceback in the folder."""

from __future__ import annotations

import time
import traceback
from pathlib import Path

import torch
import torch.multiprocessing as mp

WORLD_TIMEOUT_S = 300.0


def _engine(rank: int, inputs: dict) -> dict:
    """2 x 2 mesh: one projection sharded, its dose variant, a scan of 3
    projections over the 2 proj rows, and the samples held against the JAX
    package: a scan of the 3 views repeated and one view under several keys."""
    from cbctmc_tpu_torch.parallel import sharded

    try:
        sharded.make_mesh(3, device_type="cpu")
        indivisible = ""
    except ValueError as e:
        indivisible = str(e)
    mesh = sharded.make_mesh(2, device_type="cpu")
    scene = inputs["scene"]
    n_pix = inputs["n_pix"]
    image = sharded.run_projection_sharded(mesh, *scene, inputs["n_histories"], inputs["key"],
                                           n_pix, n_pix, config=inputs["config"])
    dose_image, dose = sharded.run_projection_sharded(
        mesh, *scene, inputs["dose_histories"], inputs["key"], n_pix, n_pix,
        config=inputs["dose_config"])
    scan = sharded.run_scan_sharded(mesh, *scene[:3], *inputs["scan_views"],
                                    inputs["scan_projections"], inputs["scan_histories"],
                                    inputs["key"], n_pix, n_pix, config=inputs["config"])
    # the samples held against the JAX package's sharded engine
    rep_scan = sharded.run_scan_sharded(mesh, *scene[:3], *inputs["rep_views"],
                                        inputs["rep_projections"], inputs["rep_histories"],
                                        inputs["rep_scan_key"], n_pix, n_pix,
                                        config=inputs["config"])
    rep_images = [sharded.run_projection_sharded(mesh, *scene, inputs["rep_histories"], key,
                                                 n_pix, n_pix, config=inputs["config"])
                  for key in inputs["rep_projection_keys"]]
    return dict(shape=tuple(mesh.shape), names=tuple(mesh.mesh_dim_names), indivisible=indivisible,
                coordinate=tuple(int(c) for c in mesh.get_coordinate()), image=image,
                dose_image=dose_image, dose=dose, scan=scan, rep_scan=rep_scan,
                rep_images=rep_images)


def _train(rank: int, inputs: dict) -> dict:
    """1 x 2 mesh: speedup train steps on this rank's half of each batch."""
    from cbctmc_tpu_torch.models import training
    from cbctmc_tpu_torch.models.speedup_net import MCSpeedUpNet
    from cbctmc_tpu_torch.parallel import sharded

    mesh = sharded.make_mesh(1, device_type="cpu")
    trainer = training.SpeedupTrainer(MCSpeedUpNet(**inputs["net"]), device="cpu",
                                      **inputs["trainer"])
    params, opt_state = inputs["params"], trainer.optimizer.init(inputs["params"])
    steps = []
    for step, batch in enumerate(inputs["batches"]):
        shard = training.shard_batch(batch, mesh, "photons")
        params, opt_state, loss = trainer._train_step(params, opt_state,
                                                      trainer.to_device(shard), step)
        steps.append(dict(loss=float(loss), params=params,
                          rows=int(shard["input"].shape[0])))
    odd = {k: v[:3] for k, v in inputs["batches"][0].items()}
    try:
        training.shard_batch(odd, mesh, "photons")
        refused = False
    except ValueError:
        refused = True
    return dict(steps=steps, refused_odd_batch=refused)


TASKS = {"engine": _engine, "train": _train}


def rank_main(rank: int, world: int, folder: str, task: str) -> None:
    import torch.distributed as dist

    from cbctmc_tpu_torch.parallel import sharded

    torch.set_num_threads(1)
    folder = Path(folder)
    try:
        sharded.initialize_multi_host(f"file://{folder / 'store'}", world, rank, backend="gloo")
        inputs = torch.load(folder / "inputs.pt", weights_only=False)
        torch.save(TASKS[task](rank, inputs), folder / f"rank{rank}.pt")
    except BaseException:
        (folder / f"rank{rank}.error").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(task: str, world: int, folder: Path, inputs: dict) -> list:
    """Run ``task`` on a gloo world of ``world`` spawned processes; returns
    each rank's result (raises with the ranks' tracebacks if one fails or
    the world outlasts WORLD_TIMEOUT_S)."""
    folder.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, folder / "inputs.pt")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, world, str(folder), task))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    for p in procs:
        p.join(max(0.1, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.terminate()
        p.join(10)
    errors = "\n".join(f.read_text() for f in sorted(folder.glob("rank*.error")))
    if hung or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"world {task!r}: {len(hung)} ranks hung, exit codes "
                           f"{[p.exitcode for p in procs]}\n{errors}")
    return [torch.load(folder / f"rank{r}.pt", weights_only=False) for r in range(world)]
