"""The NUTS kernel on its built-ins with data, at 8 and 32 lanes a chain,
and its diagonal body against an earlier copy of the source.

Run from the repository root on a machine with the card and ``nvcc``::

    python3 scripts/profile_nuts_data.py [--parent DIR] [--out FILE]

1. Builds ``csrc/nuts_step.cu`` as the library does (``ops/_build.py``) and
   twice more with ``-DZS_NUTS_DATA_LANES=8`` and ``=32`` (``nvcc`` with the
   same flags, into ``$TMPDIR``), printing ptxas' register and spill report
   of each build's data-density kernels.
2. For each built-in of ``chip_smoke.py`` phase 35 (eight schools centred
   and non-centred, ordinal regression, Weibull AFT survival; the examples'
   chains and data), warms the chains up with ``ROBUST_WARM`` adaptive NUTS
   iterations, then runs one transition at the adapted step on both widths
   in turns (8, 32, 8, 32): the chains that differ from the plain version on
   the same injected noise, and the times back to back (CUDA events over 20
   launches) and replayed from a CUDA graph of 20 (the device alone).
3. With ``--parent DIR`` (an earlier ``zhusuan_tpu_torch/csrc``, e.g.
   ``git archive <commit> zhusuan_tpu_torch/csrc`` unpacked into a
   git-ignored directory): builds its ``nuts_step.cu`` the same way, prints
   its ptxas report, and holds the current diagonal-Gaussian kernel against
   it bit for bit (every output, ``torch.equal``) at 4096 x 100, depths 6, 8
   and 10, on its own Philox draws and on injected ones.

Prints one JSON object (and writes it to ``--out`` when given).
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from zhusuan_tpu_torch.mcmc.nuts import draw_noise  # noqa: E402
from zhusuan_tpu_torch.ops import _build, nuts_step  # noqa: E402

ENTRIES = ("zs_fused_nuts_transition", "zs_fused_nuts_transition_data",
           "zs_cuda_error_string")


def _build_variant(src, out, defines=()):
    """``(path, ptxas lines)`` of ``src`` built with the library's flags
    and ``defines``."""
    flags = list(_build.NVCC_FLAGS) + ["-fmad=false"] + list(defines)
    log = subprocess.run([_build._nvcc(), *flags, "-o", out, src],
                         capture_output=True, text=True, check=True)
    text = log.stdout + log.stderr
    return out, [ln.strip() for ln in text.splitlines()
                 if "Compiling entry" in ln or "registers" in ln
                 or "spill" in ln]


def _loader(path, typed):
    """A ``kernel_library`` stand-in that loads ``path``, its entries typed
    as the library's (``typed``)."""
    lib = ctypes.CDLL(path)
    for name in ENTRIES:
        if hasattr(lib, name):
            getattr(lib, name).argtypes = getattr(typed, name).argtypes
            getattr(lib, name).restype = getattr(typed, name).restype
    return lambda: (lib, {"path": path})


def _widths(torch, dev, loaders):
    """Step 2: each built-in at every width in ``loaders``, in turns."""
    ref = cs._robust_reference()
    out = {}
    for name, _, dens, to_u, init, depth, c in cs._robust_builtins(
            torch, dev, ref):
        q, step = cs._robust_warm(torch, dev, dens, to_u, init, depth)
        ones = torch.ones(1, dens.dim, device=dev)
        noise = draw_noise(torch.Generator(device=dev).manual_seed(1), c,
                           dens.dim, depth, torch.float32, dev)
        want = nuts_step.fused_nuts_transition_reference(
            dens, q, ones, step, depth, 1000.0, (5, 6), 1, noise=noise)
        rec = {"shape": [c, dens.dim], "n_rows": dens.n_rows,
               "depth": depth, "step": step}
        for _ in range(2):
            for lanes, loader in loaders.items():
                nuts_step.kernel_library = loader
                got = nuts_step._launch(dens, q, ones, step, depth, 1000.0,
                                        (5, 6), 1, noise, True)
                torch.cuda.synchronize()
                cmp = cs._compare_nuts(torch, got, want)

                def fn():
                    return nuts_step._launch(dens, q, ones, step, depth,
                                             1000.0, (7, 8), 1, None, True)

                rec.setdefault("lanes%d" % lanes, []).append({
                    "graph_ms": cs._graph_ms(torch, fn, 20),
                    "ms": cs._time_ms(torch, fn, 20),
                    "differing": cmp["tree_differing"]
                    + cmp["selection_differing"],
                    "leapfrogs": int(fn()[5].sum())})
        out[name] = rec
    return out


def _diagonal_bits(torch, dev, parent_loader, current_loader):
    """Step 3: the diagonal Gaussian through the current and the parent's
    library, every output compared with ``torch.equal``."""
    out = {}
    for depth, std_max in ((6, 1.0), (8, 30.0), (10, 30.0)):
        dens, q, inv_mass = cs._nuts_problem(torch, dev, cs.NUTS_CHAINS,
                                             cs.DIM, std_max, depth)
        injected = draw_noise(torch.Generator(device=dev).manual_seed(depth),
                              cs.NUTS_CHAINS, cs.DIM, depth, torch.float32,
                              dev)
        for label, noise in (("own", None), ("injected", injected)):
            outs = []
            for loader in (parent_loader, current_loader):
                nuts_step.kernel_library = loader
                outs.append(nuts_step.fused_nuts_transition(
                    dens, q, inv_mass, 0.1, depth, 1000.0, (3, 4), 1,
                    noise=noise))
            torch.cuda.synchronize()
            out["depth%d_%s" % (depth, label)] = all(
                torch.equal(a, b) for a, b in zip(*outs))
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", default=None)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    dev = torch.device("cuda", 0)
    src = os.path.join(_build.CSRC_DIR, "nuts_step.cu")
    typed, record = nuts_step.kernel_library()
    result = {"card": cs.phase_device(torch),
              "ptxas": {"current": [ln.strip() for ln in
                                    record["log"].splitlines()
                                    if "registers" in ln or "spill" in ln]}}
    current = nuts_step.kernel_library
    with tempfile.TemporaryDirectory() as tmp:
        loaders = {}
        for lanes in (8, 32):
            path, ptxas = _build_variant(
                src, os.path.join(tmp, "nuts_l%d.so" % lanes),
                ["-DZS_NUTS_DATA_LANES=%d" % lanes])
            result["ptxas"]["lanes%d" % lanes] = ptxas
            loaders[lanes] = _loader(path, typed)
        try:
            result["widths"] = _widths(torch, dev, loaders)
            if args.parent:
                path, ptxas = _build_variant(
                    os.path.join(args.parent, "nuts_step.cu"),
                    os.path.join(tmp, "nuts_parent.so"))
                result["ptxas"]["parent"] = ptxas
                result["diagonal_bits_equal"] = _diagonal_bits(
                    torch, dev, _loader(path, typed), current)
        finally:
            nuts_step.kernel_library = current
    text = json.dumps(result)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
