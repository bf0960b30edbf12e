"""Old against new: the whole-fit ADVI trainer (K11, ``csrc/advi_step.cu``)
and the SGLD kernel (K3, ``csrc/sgmcmc_step.cu``) beside an earlier copy of
the same two sources, on one card in one process.

Run from the repository root on a machine with the card and ``nvcc``::

    python3 scripts/profile_advi_sgld.py --parent DIR [--sweep] [--clocks]
        [--quick] [--out FILE]

``DIR`` holds the earlier ``advi_step.cu``, ``sgmcmc_step.cu`` and their
headers as they were before the trainer went onto a cluster (one block a
fit) and SGLD got its flat body, for example ``git archive 1a8224e
zhusuan_tpu_torch/csrc`` unpacked into a git-ignored directory. The script

1. builds the current sources (``ops/_build.py``) and the earlier ones
   (``nvcc`` with the same flags, into ``$TMPDIR``) and prints ptxas'
   registers, shared memory and spills for every kernel instantiation;
2. holds the current kernels against the earlier ones on the same inputs,
   by the elements that differ (0 expected: both agree bit for bit with the
   plain versions while the float64 sums are exact);
3. unless ``--quick``, times them in turns (earlier, current, current,
   earlier), back to back (CUDA events) and replayed from a CUDA graph (the
   device alone): K11 at chip_smoke.py phase 17's three timing shapes
   (toy2d 500 x 2, a fit of ``chip_smoke.TOY2D_STEPS`` steps; the diagonal
   Gaussian at 64 x 100 and 32 x 100, 2000 steps), K3 at 32768 x 100 (the
   flat body, and the warp body forced), at 32768 x 99 (the warp body) and
   at 32768 x 100 on the equicorrelated density;
4. with ``--sweep``, times a 2000-step fit at each timing shape and at
   ``SWEEP_EXTRA``'s on every (cluster, warps) layout of ``SWEEP``, beside
   the earlier kernel: the measurements behind
   ``ops/advi_step.py::advi_layout``;
5. with ``--clocks``, builds the current ADVI source with
   ``-DZS_ADVI_CLOCKS`` and a copy of the earlier one with the same
   ``clock64`` stamps put in by :func:`patch_parent_clocks`, and prints the
   cycles a step that thread 0 of block 0 spends in each part.

Prints one JSON object (and writes it to ``--out`` when given).
"""

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from zhusuan_tpu_torch.ops import _build, advi_step, sgld_step  # noqa: E402
from zhusuan_tpu_torch.ops._launch import current_stream_pointer  # noqa: E402
from zhusuan_tpu_torch.ops.hmc_step import density_pointers  # noqa: E402

KEY = (0x0BADCAFE, 0x00C0FFEE)
# (kind, dim, particles, steps of the timed fit)
ADVI_SHAPES = (("toy2d", 2, 500, cs.TOY2D_STEPS), ("diagonal", 100, 64, 2000),
               ("diagonal", 100, 32, 2000))
SWEEP_STEPS = 2000
SWEEP = [(c, w) for c in (1, 2, 4, 8, 12, 16) for w in (1, 2, 4, 8, 16)]
# Shapes the sweep adds to ADVI_SHAPES: few and many rows a lane or a warp,
# the other widths.
SWEEP_EXTRA = (("toy2d", 2, 40), ("diagonal", 3, 3000), ("diagonal", 100, 7),
               ("diagonal", 100, 200), ("equicorrelated", 37, 75),
               ("diagonal", 400, 21))
# The layouts whose clock64 split --clocks also prints (besides the rule's).
CLOCK_LAYOUTS = ((1, 8), (4, 4), (8, 4), (8, 8), (16, 1), (16, 4))
SG_SHAPES = (("diagonal", 100, None), ("diagonal", 100, "warp"),
             ("diagonal", 99, None), ("equicorrelated", 100, None))
SG_CHAINS = 32768
SG_LR = 0.01
REPS_GRAPH = 20

PARENT_CLOCK_DEFS = r"""
// clock64 stamps (put in by scripts/profile_advi_sgld.py), kept in
// registers as in the current source
__device__ unsigned long long g_clocks[6];
#define ZS_CLOCK_START                      \
  long long zs_clock_last = clock64();      \
  unsigned long long zs_clock_sum[6] = {}
#define ZS_STAMP(part)                                                  \
  do {                                                                  \
    const long long zs_now = clock64();                                 \
    zs_clock_sum[part] +=                                               \
        static_cast<unsigned long long>(zs_now - zs_clock_last);        \
    zs_clock_last = zs_now;                                             \
  } while (0)
#define ZS_COUNT_STEP zs_clock_sum[5] += 1
#define ZS_CLOCK_FLUSH                                                  \
  if (blockIdx.x == 0 && threadIdx.x == 0)                              \
    for (int zs_i = 0; zs_i < 6; ++zs_i) g_clocks[zs_i] += zs_clock_sum[zs_i]
"""
PARENT_CLOCK_ENTRY = r"""
extern "C" int zs_advi_clocks(unsigned long long* out) {
  cudaError_t rc = cudaMemcpyFromSymbol(out, g_clocks, sizeof(g_clocks));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const unsigned long long zero[6] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_clocks, zero, sizeof(zero)));
}
"""
# The parts, in the current kernel and in the earlier one (one block:
# the particle noise inline with the rows, two block barriers a step).
CLOCK_PARTS = {
    "current": ("noise (while the pushed stores fly)", "density (the rows)",
                "reduce (warp butterflies; at dim > 4 the block's sums)",
                "exchange (push, wait on the transaction barrier)",
                "adam (partials' sums, Adam; block barrier at dim > 4)"),
    "parent": ("noise (inline, thread 0's rows)", "density (the rows)",
               "reduce (butterflies / shared writes, first barrier)",
               "second block barrier",
               "column sums (warp 0 / thread j) and Adam"),
}


def patch_parent_clocks(src: str) -> str:
    """The earlier ``advi_step.cu`` (one block a fit) with clock64 stamps at
    the parts of its step; raises if an anchor is missing."""
    def sub(old, new, count=1):
        nonlocal src
        if src.count(old) != count:
            raise RuntimeError("anchor not found {} time(s): {!r}".format(
                count, old[:60]))
        src = src.replace(old, new)

    sub('#include "philox.cuh"\n', '#include "philox.cuh"\n'
        + PARENT_CLOCK_DEFS)
    sub("  __syncthreads();\n\n  for (int t = 0; t < a.n_steps; ++t) {\n",
        "  __syncthreads();\n  ZS_CLOCK_START;\n\n"
        "  for (int t = 0; t < a.n_steps; ++t) {\n", 2)
    # warp-a-row kernel
    sub("            zs::normals4(static_cast<uint32_t>(t), "
        "static_cast<uint32_t>(row),\n"
        "                         static_cast<uint32_t>(grp), "
        "zs::kStreamAdviNoise,\n"
        "                         a.key0, a.key1, nz);\n",
        "            ZS_STAMP(1);\n"
        "            zs::normals4(static_cast<uint32_t>(t), "
        "static_cast<uint32_t>(row),\n"
        "                         static_cast<uint32_t>(grp), "
        "zs::kStreamAdviNoise,\n"
        "                         a.key0, a.key1, nz);\n"
        "            ZS_STAMP(0);\n")
    sub("#pragma unroll\n    for (int e = 0; e < E; ++e) {\n"
        "      const int j = 4 * (32 * (e / 4) + lane) + e % 4;\n"
        "      red_g[warp * DP + j] = acc_g[e];",
        "    ZS_STAMP(1);\n#pragma unroll\n    for (int e = 0; e < E; ++e) {\n"
        "      const int j = 4 * (32 * (e / 4) + lane) + e % 4;\n"
        "      red_g[warp * DP + j] = acc_g[e];")
    sub("      red_e[warp] = acc_e;\n    }\n    __syncthreads();\n",
        "      red_e[warp] = acc_e;\n    }\n    __syncthreads();\n"
        "    ZS_STAMP(2);\n")
    sub("          ((-mean_f - 0.5f * mean_e2) - a.loss_const) - sum_ls;\n"
        "    }\n    __syncthreads();\n  }\n",
        "          ((-mean_f - 0.5f * mean_e2) - a.loss_const) - sum_ls;\n"
        "    }\n    ZS_STAMP(4);\n    __syncthreads();\n    ZS_STAMP(3);\n"
        "    ZS_COUNT_STEP;\n  }\n  ZS_CLOCK_FLUSH;\n")
    # lane-a-row kernel
    sub("        zs::normals4(static_cast<uint32_t>(t), "
        "static_cast<uint32_t>(row), 0u,\n"
        "                     zs::kStreamAdviNoise, a.key0, a.key1, nz);\n",
        "        ZS_STAMP(1);\n"
        "        zs::normals4(static_cast<uint32_t>(t), "
        "static_cast<uint32_t>(row), 0u,\n"
        "                     zs::kStreamAdviNoise, a.key0, a.key1, nz);\n"
        "        ZS_STAMP(0);\n")
    sub("#pragma unroll\n    for (int q = 0; q < Q; ++q) {\n"
        "      const double v = warp_sum(acc[q]);",
        "    ZS_STAMP(1);\n#pragma unroll\n    for (int q = 0; q < Q; ++q) {\n"
        "      const double v = warp_sum(acc[q]);")
    sub("      if (lane == 0) red[q][warp] = v;\n    }\n    __syncthreads();\n",
        "      if (lane == 0) red[q][warp] = v;\n    }\n    __syncthreads();\n"
        "    ZS_STAMP(2);\n")
    sub("            ((-mean_f - 0.5f * mean_e2) - a.loss_const) - sum_ls;\n"
        "      }\n    }\n    __syncthreads();\n  }\n",
        "            ((-mean_f - 0.5f * mean_e2) - a.loss_const) - sum_ls;\n"
        "      }\n    }\n    ZS_STAMP(4);\n    __syncthreads();\n"
        "    ZS_STAMP(3);\n    ZS_COUNT_STEP;\n  }\n  ZS_CLOCK_FLUSH;\n")
    return src + PARENT_CLOCK_ENTRY


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")


def ptxas_report(log: str):
    """``[(kernel, "Used ... registers ...", spill line)]`` from an
    ``nvcc -Xptxas -v`` log, names demangled where ``c++filt`` exists."""
    out, name = [], None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            name = m.group(1)
        elif name and ("registers" in line or "spill" in line):
            out.append((name, line.split(":", 1)[-1].strip()))
    demangle = shutil.which("c++filt")
    if demangle and out:
        names = subprocess.run([demangle], input="\n".join(n for n, _ in out),
                               capture_output=True, text=True).stdout.split(
                                   "\n")
        out = [(names[i] or n, s) for i, (n, s) in enumerate(out)]
    merged = {}
    for n, s in out:
        merged.setdefault(n, []).append(s)
    return {n: " | ".join(v) for n, v in merged.items()}


def nvcc(src, out, defines=()):
    flags = list(_build.NVCC_FLAGS) + ["-fmad=false"] + list(defines)
    res = subprocess.run([_build._nvcc(), *flags, "-o", out, src],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed on {}:\n{}{}".format(
            src, res.stdout, res.stderr))
    return res.stdout + res.stderr


def typed(lib, parent):
    """Set the entries' argument types: the earlier entries take no layout
    (ADVI) and no body flag (SGLD)."""
    ptr, i32, u32, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                          ctypes.c_float)
    if hasattr(lib, "zs_fused_meanfield_advi"):
        lib.zs_fused_meanfield_advi.argtypes = (
            [i32] + [ptr] * 6 + [i32] * (3 if parent else 5) + [f32] * 6
            + [u32] * 2 + [ptr] * 4)
        lib.zs_fused_meanfield_advi.restype = i32
    if hasattr(lib, "zs_fused_sgld_step"):
        lib.zs_fused_sgld_step.argtypes = (
            [ptr, i32, ptr, ptr, ptr, f32, ptr, i32, i32, u32, u32, u32]
            + ([] if parent else [i32]) + [ptr, ptr])
        lib.zs_fused_sgld_step.restype = i32
    try:
        lib.zs_advi_clocks.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
        lib.zs_advi_clocks.restype = i32
    except AttributeError:
        pass
    return lib


def _rc(rc, what):
    if rc != 0:
        raise RuntimeError("{} failed: CUDA error {}".format(what, rc))


def advi_problem(kind, d, n, steps, dev):
    dens, loc0, ls0, lr = cs._advi_density(torch, dev, kind, d)
    table = advi_step.schedule_table(lr, steps, 0.9, 0.999, dev)
    outs = (torch.empty(d, device=dev), torch.empty(d, device=dev),
            torch.empty(steps, device=dev))
    head = (*density_pointers(dens, dev), loc0.data_ptr(), ls0.data_ptr(),
            table.data_ptr(), None, steps, n, d)
    tail = (*advi_step._adam_constants(0.9, 0.999, 1e-8, d), *KEY,
            *(o.data_ptr() for o in outs))
    return {"keep": (dens, loc0, ls0, table), "head": head, "tail": tail,
            "outs": outs, "n": n, "d": d, "steps": steps}


def advi_call(lib, prob, layout=None):
    """One fit; ``layout`` ``(cluster, warps)`` for the current entry (None:
    :func:`advi_layout`'s), nothing for the earlier one."""
    stream = current_stream_pointer(torch.cuda.current_device())
    if getattr(lib, "_zs_parent", False):
        args = prob["head"] + prob["tail"]
    else:
        if layout is None:
            layout = advi_step.advi_layout(prob["d"], prob["n"])[:2]
        args = prob["head"] + tuple(layout) + prob["tail"]
    _rc(lib.zs_fused_meanfield_advi(*args, stream), "zs_fused_meanfield_advi")


def sg_problem(kind, d, path, dev):
    dens, q, _, _ = cs._family_problem(torch, dev, SG_CHAINS, d, kind, 5)
    out = torch.empty_like(q)
    flat = sgld_step.sgld_layout(dens, d) == "flat" and path != "warp"
    head = (q.data_ptr(), *density_pointers(dens, dev), None, SG_LR, None,
            SG_CHAINS, d, *KEY, 3)
    return {"keep": (dens, q), "head": head, "out": out, "flat": flat}


def sg_call(lib, prob):
    stream = current_stream_pointer(torch.cuda.current_device())
    if getattr(lib, "_zs_parent", False):
        args = prob["head"] + (prob["out"].data_ptr(),)
    else:
        args = prob["head"] + (int(prob["flat"]), prob["out"].data_ptr())
    _rc(lib.zs_fused_sgld_step(*args, stream), "zs_fused_sgld_step")


def differing(a_outs, b_outs):
    return [int(((a != b) & ~(torch.isnan(a) & torch.isnan(b))).sum())
            for a, b in zip(a_outs, b_outs)]


def in_turns(fns, reps_b2b, reps_graph):
    """Times of ``fns`` (``{name: fn}``) in the order earlier, current,
    current, earlier: back to back and replayed from a CUDA graph."""
    order = ["parent", "current", "current", "parent"]
    res = {name: {"b2b_ms": [], "graph_ms": []} for name in fns}
    for name in order:
        res[name]["b2b_ms"].append(cs._time_ms(torch, fns[name], reps_b2b))
        res[name]["graph_ms"].append(cs._graph_ms(torch, fns[name],
                                                  reps_graph))
    return res


def clocks(lib, prob, layout=None):
    advi_call(lib, prob, layout)
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 6)()
    _rc(lib.zs_advi_clocks(buf), "zs_advi_clocks")  # zero them
    advi_call(lib, prob, layout)
    torch.cuda.synchronize()
    _rc(lib.zs_advi_clocks(buf), "zs_advi_clocks")
    steps = max(1, buf[5])
    return [buf[i] / steps for i in range(5)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--clocks", action="store_true")
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=DIR")
    ap.add_argument("--out")
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    report = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "parent_dir": args.parent}

    def dump():  # after every part, so that a later failure keeps it
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(report, f)

    tmp = tempfile.mkdtemp(prefix="zs_profile_advi_")
    libs = _build.build_libraries(["advi_step", "sgmcmc_step"])
    current = {name: typed(lib, False) for name, (lib, _) in libs.items()}
    report["ptxas"] = {name: ptxas_report(rec["log"])
                       for name, (_, rec) in libs.items()}
    parent = {}
    for name in ("advi_step", "sgmcmc_step"):
        src = os.path.join(args.parent, name + ".cu")
        so = os.path.join(tmp, "parent_" + name + ".so")
        report["ptxas"]["parent_" + name] = ptxas_report(nvcc(src, so))
        lib = typed(ctypes.CDLL(so), True)
        lib._zs_parent = True
        parent[name] = lib

    # 2. Agreement with the earlier kernels.
    agree = {}
    for kind, d, n, _ in ADVI_SHAPES:
        prob = advi_problem(kind, d, n, 200, dev)
        advi_call(parent["advi_step"], prob)
        want = [o.clone() for o in prob["outs"]]
        advi_call(current["advi_step"], prob)
        torch.cuda.synchronize()
        agree["advi_{}_d{}_n{}".format(kind, d, n)] = differing(
            prob["outs"], want)
    for kind, d, path in SG_SHAPES:
        prob = sg_problem(kind, d, path, dev)
        sg_call(parent["sgmcmc_step"], prob)
        want = prob["out"].clone()
        sg_call(current["sgmcmc_step"], prob)
        torch.cuda.synchronize()
        agree["sgld_{}_d{}_{}".format(kind, d, path or "auto")] = differing(
            [prob["out"]], [want])
    report["differing_from_parent"] = agree
    dump()

    # 3. Times in turns.
    if not args.quick:
        timing = {}
        for kind, d, n, steps in ADVI_SHAPES:
            prob = advi_problem(kind, d, n, steps, dev)
            fns = {"parent": lambda p=prob: advi_call(parent["advi_step"], p),
                   "current": lambda p=prob: advi_call(current["advi_step"],
                                                       p)}
            rec = in_turns(fns, 3, 2)
            for side in rec.values():
                side["us_per_step_graph"] = [
                    ms / steps * 1e3 for ms in side["graph_ms"]]
            rec["steps"] = steps
            rec["layout"] = advi_step.advi_layout(d, n)
            timing["advi_{}_d{}_n{}".format(kind, d, n)] = rec
        for kind, d, path in SG_SHAPES:
            prob = sg_problem(kind, d, path, dev)
            fns = {"parent": lambda p=prob: sg_call(parent["sgmcmc_step"], p),
                   "current": lambda p=prob: sg_call(current["sgmcmc_step"],
                                                     p)}
            rec = in_turns(fns, 200, REPS_GRAPH)
            rec["flat"] = prob["flat"]
            rec["bound_ms"] = cs._sgmcmc_bound("sgld", SG_CHAINS, d)[
                "bound_ms"]
            timing["sgld_{}_d{}_{}".format(kind, d, path or "auto")] = rec
        report["timing"] = timing
        dump()

    # 4. The layouts.
    if args.sweep:
        sweep = {}
        for kind, d, n in [s[:3] for s in ADVI_SHAPES] + list(SWEEP_EXTRA):
            prob = advi_problem(kind, d, n, SWEEP_STEPS, dev)
            rows = {"parent": cs._graph_ms(torch, lambda: advi_call(
                parent["advi_step"], prob), 2) / SWEEP_STEPS * 1e3,
                "rule": "{}x{}".format(*advi_step.advi_layout(d, n))}
            for c, w in SWEEP:
                if not advi_step._layout_fits(d, c, w):
                    continue
                try:
                    ms = cs._graph_ms(torch, lambda: advi_call(
                        current["advi_step"], prob, (c, w)), 2)
                    rows["{}x{}".format(c, w)] = ms / SWEEP_STEPS * 1e3
                except RuntimeError as err:  # a cluster the card refuses
                    rows["{}x{}".format(c, w)] = str(err)
                    torch.cuda.synchronize()
            sweep["advi_{}_d{}_n{}".format(kind, d, n)] = rows
        report["sweep_us_per_step"] = sweep
        dump()

    # Variants: copies of the current ADVI source with one change each,
    # timed beside it in turns (current, variants..., current) at the rule's
    # layout and at CLOCK_LAYOUTS, and held to it bit for bit.
    if args.variant:
        variants = {"current": current["advi_step"]}
        for spec in args.variant:
            name, vdir = spec.split("=", 1)
            so = os.path.join(tmp, "variant_{}.so".format(name))
            report["ptxas"]["variant_" + name] = ptxas_report(
                nvcc(os.path.join(vdir, "advi_step.cu"), so))
            variants[name] = typed(ctypes.CDLL(so), False)
        order = ["current"] + [v.split("=", 1)[0] for v in args.variant] + [
            "current"]
        vt = {}
        for kind, d, n, _ in ADVI_SHAPES:
            prob = advi_problem(kind, d, n, SWEEP_STEPS, dev)
            rec = {}
            for layout in [advi_step.advi_layout(d, n)[:2]] + list(
                    CLOCK_LAYOUTS):
                row = {}
                advi_call(current["advi_step"], prob, layout)
                want = [o.clone() for o in prob["outs"]]
                for name in order:
                    ms = cs._graph_ms(torch, lambda: advi_call(
                        variants[name], prob, layout), 2)
                    row.setdefault(name, []).append(ms / SWEEP_STEPS * 1e3)
                    if name != "current":
                        row[name + "_differing"] = differing(prob["outs"],
                                                             want)
                rec["{}x{}".format(*layout)] = row
            vt["advi_{}_d{}_n{}".format(kind, d, n)] = rec
        report["variants_us_per_step"] = vt
        dump()

    # 5. clock64 splits.
    if args.clocks:
        src = os.path.join(_build.CSRC_DIR, "advi_step.cu")
        so = os.path.join(tmp, "clocks_advi_step.so")
        nvcc(src, so, ["-DZS_ADVI_CLOCKS"])
        cur = typed(ctypes.CDLL(so), False)
        pdir = os.path.join(tmp, "parent_clocks")
        shutil.copytree(args.parent, pdir)
        with open(os.path.join(pdir, "advi_step.cu")) as f:
            patched = patch_parent_clocks(f.read())
        with open(os.path.join(pdir, "advi_step.cu"), "w") as f:
            f.write(patched)
        pso = os.path.join(tmp, "parent_clocks_advi_step.so")
        nvcc(os.path.join(pdir, "advi_step.cu"), pso)
        par = typed(ctypes.CDLL(pso), True)
        par._zs_parent = True
        split = {"parts": CLOCK_PARTS}
        for kind, d, n, _ in ADVI_SHAPES:
            prob = advi_problem(kind, d, n, SWEEP_STEPS, dev)
            rec = {"parent": clocks(par, prob)}
            for layout in [advi_step.advi_layout(d, n)[:2]] + list(
                    CLOCK_LAYOUTS):
                rec["current_{}x{}".format(*layout)] = clocks(cur, prob,
                                                              layout)
            split["advi_{}_d{}_n{}".format(kind, d, n)] = rec
        report["clocks_per_step"] = split

    dump()
    print(json.dumps(report))
    shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
