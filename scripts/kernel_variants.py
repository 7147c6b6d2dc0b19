"""What the kernel comparison scripts share (``compare_*_kernels.py``):
one process per checkout of the repository, in turns, and variants of a
kernel built from text edits of this checkout's sources and swapped in
behind the package's own wrapper.

A script calls :func:`main` with its docstring, its own path and its
``child(root, with_variants)``; the child imports the checkout's
``chip_smoke.py`` and package (:func:`enter`), measures, and ends with
:func:`emit`. The parent prints every child's output and, as the last line,
one JSON object ``{"runs": [...]}`` with every child's result.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

_RESULT = "RESULT "


def enter(root: Path):
    """Make the checkout ``root`` the one this process imports; returns its
    ``chip_smoke`` module."""
    sys.path.insert(0, str(root))
    os.chdir(root)
    import chip_smoke

    return chip_smoke


def emit(result: dict) -> None:
    """The child's result, as the line its parent reads."""
    print(_RESULT + json.dumps(result), flush=True)


def build_variants(kernels, variants: dict, subs: dict | None = None) -> dict:
    """Compile variants of this checkout's kernels, one ``nvcc`` each, all
    started together. ``variants`` maps a name to ``(kernel, {source file:
    [(text, replacement), ...]})``: the kernel's ``.cu`` file and the
    ``.cuh`` headers are copied with the edits made (each text must occur
    once; ``subs`` maps placeholders in a replacement to their values).
    Returns ``{name: (kernel, launch function)}`` with the shipped kernel's
    signature."""
    procs = {}
    for name, (kernel, edits) in variants.items():
        out = kernels.BUILD_DIR / "variants" / name
        out.mkdir(parents=True, exist_ok=True)
        for src in [kernels.CSRC / f"{kernel}.cu", *sorted(kernels.CSRC.glob("*.cuh"))]:
            text = src.read_text()
            for old, new in edits.get(src.name, []):
                if text.count(old) != 1:
                    raise AssertionError(f"{name}: {old!r} occurs {text.count(old)} times")
                for key, value in (subs or {}).items():
                    new = new.replace(key, value)
                text = text.replace(old, new)
            (out / src.name).write_text(text)
        lib = out / f"lib{name}.so"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib), str(out / f"{kernel}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), kernel, lib)
    built = {}
    for name, (proc, kernel, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        (lib.parent / "build_log.txt").write_text(log)
        fn = getattr(ctypes.CDLL(str(lib)), f"{kernel}_launch")
        fn.argtypes = kernels._SIGNATURES[kernel]
        fn.restype = ctypes.c_int
        built[name] = (kernel, fn)
    return built


@contextlib.contextmanager
def swapped(kernels, kernel: str, fn):
    """The package's wrapper of ``kernel`` launches ``fn`` inside the block."""
    shipped = kernels._launcher(kernel)
    kernels._libs[kernel] = fn
    try:
        yield
    finally:
        kernels._libs[kernel] = shipped


def main(doc: str, script: str, child) -> int:
    """``script ROOT [ROOT ...] [--variants] [--flag=value ...]``:
    ``child(root, with_variants)`` in a process of its own for each ROOT in
    the order given; the variants only in the process of the checkout that
    holds ``script``. Other ``--`` flags are handed on to every child, which
    reads them from ``sys.argv``."""
    import torch

    args = sys.argv[1:]
    with_variants = "--variants" in args
    if args and args[0] == "--child":
        child(Path(args[1]).resolve(), with_variants)
        return 0
    if not torch.cuda.is_available():
        print(f"{Path(script).stem}: no CUDA device, nothing run", file=sys.stderr)
        return 2
    roots = [a for a in args if not a.startswith("--")]
    flags = [a for a in args if a.startswith("--") and a != "--variants"]
    if not roots:
        print(doc, file=sys.stderr)
        return 2
    script = str(Path(script).resolve())
    home = Path(script).parents[1]
    results = []
    for root in roots:
        cmd = [sys.executable, script, "--child", root, *flags]
        if with_variants and Path(root).resolve() == home:
            cmd.append("--variants")
        proc = subprocess.run(cmd, capture_output=True, text=True)
        print(f"== {root}\n{proc.stdout}{proc.stderr[-4000:]}", flush=True)
        if proc.returncode != 0:
            raise SystemExit(f"{root}: exit code {proc.returncode}")
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(_RESULT)]
        results.append(json.loads(lines[-1][len(_RESULT):]))
    print(json.dumps({"runs": results}))
    return 0
