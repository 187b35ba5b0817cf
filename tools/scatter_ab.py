"""Designs of the scatter kernel against the package's, in turns on one card.

Each design is a whole CUDA source with the C interface of
``sdfest_torch/csrc/scatter.cu`` (``sdfest_scatter``,
``sdfest_scatter_words``), built with the package's nvcc flags into
``sdfest_torch/_build/ab/`` and put in the wrapper's place.  In turns base,
designs, designs reversed, base, each times (CUDA events, mean per call)
chip_smoke's backward rows of the main path (8 sets, 4 passes), the same
rows with zero cotangents, the 8 as one launch of B = 8, and the rows with
the mug 0.2 m and 0.12 m ahead; before it times, it holds the main set,
the batch and the 0.12 m set to ``scatter_plain`` on CPU copies bit for
bit.  It ends with each design's device time per stage (torch.profiler).
Run from the repository root on the machine with the card::

    python3 tools/scatter_ab.py NAME=path/to/design.cu [NAME=...]
"""
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from sdfest_torch.render import _build, kernels as k  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int


def build(designs):
    """Build each design's library at once; ``{name: CDLL}``."""
    out = os.path.join(_build.BUILD_ROOT, "ab")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, src in designs.items():
        lib = os.path.join(out, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.FLAGS, "-I", _build.CSRC, "-o", lib,
             os.path.abspath(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            print(f"{name}: build failed\n{log[-3000:]}")
            continue
        print(name, *(line.strip() for line in log.splitlines()
                      if "registers" in line or "spill" in line))
        libs[name] = ctypes.CDLL(lib)
    return libs


def use(libs, name):
    """Point the wrapper at a design's library (``base``: the package's)."""
    k._FUNCS.clear()
    if name == "base":
        return
    for wrapper, symbol, argtypes, restype in (
            ("scatter", "sdfest_scatter", [_P] * 4 + [_I] * 3 + [_P],
             ctypes.c_int),
            ("scatter_words", "sdfest_scatter_words", [_I] * 3,
             ctypes.c_longlong)):
        fn = getattr(libs[name], symbol)
        fn.argtypes, fn.restype = argtypes, restype
        k._FUNCS[wrapper] = fn


def main():
    designs = dict(a.split("=", 1) for a in sys.argv[1:])
    print(cs.card_line())
    _build.build()
    libs = build(designs)
    smoke = cs.Smoke()
    res = smoke.sdf.shape[0]
    gen = torch.Generator().manual_seed(3)
    sets = [smoke.backward_rows(cs.GT_POSES[i % len(cs.GT_POSES)], 100 + i,
                                gen) for i in range(8)]
    batch = tuple(torch.stack([x[t] for x in sets]) for t in (0, 1))
    q = cs.GT_POSES[0][2]
    dense = {d: smoke.backward_rows(((0.0, 0.0, -d), 0.1, q), 200, gen)
             for d in (0.2, 0.12)}
    data = {"main": sets * 4,
            "zeros": [(p, torch.zeros_like(c)) for p, c in sets] * 4,
            "B8": [batch] * 6,
            "dense0.2": [dense[0.2]] * 8,
            "dense0.12": [dense[0.12]] * 8}
    checks = [sets[0], batch, dense[0.12]]
    want = [k.scatter_plain(p.cpu(), c.cpu(), res) for p, c in checks]
    names = ["base"] + list(libs)
    rows = {n: {} for n in names}
    for turn in names + names[::-1]:
        use(libs, turn)
        for (p, c), w in zip(checks, want):
            assert torch.equal(k.scatter(p, c, res).cpu(), w), turn
        for label, x in data.items():
            ms = cs.cuda_ms(lambda y: k.scatter(*y, res), x)
            rows[turn].setdefault(label, []).append(round(ms * 1e3, 2))
    for n in names:
        use(libs, n)
        stages = cs.scatter_stage_ms(sets, res)
        print(n, rows[n], "(us per call; bit for bit) stages (us per "
              "launch):", {s: round(t * 1e3, 2) for s, t in stages.items()},
              flush=True)


if __name__ == "__main__":
    main()
