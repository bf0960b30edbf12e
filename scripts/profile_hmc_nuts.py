"""Old against new: the NUTS kernel (K8/K9) and the HMC-family body (K1,
K2, K7) of ``zhusuan_tpu_torch/csrc`` beside an earlier copy of the same
two sources, on one card in one process.

Run from the repository root on a machine with the card and ``nvcc``::

    python3 scripts/profile_hmc_nuts.py --parent DIR [--quick] [--out FILE]

``DIR`` holds an earlier ``nuts_step.cu``, ``hmc_step.cu`` and their
headers (the tree before the NUTS chains were put on lane groups: a warp a
chain), for example ``git archive <commit> zhusuan_tpu_torch/csrc``
unpacked into a git-ignored directory. The script

1. builds the current sources (``ops/_build.py``), the earlier ones and the
   current NUTS kernel at 16 and 32 lanes a chain (``-DZS_NUTS_LANES``;
   ``nvcc`` with the same flags, into ``$TMPDIR``), and counts each
   kernel's SASS (``cuobjdump -sass``): its instructions, and for each loop
   (a backward branch) the instructions between its head and its branch,
   with the shuffles and special-function (MUFU) instructions among them;
2. holds the current kernels against the earlier ones on the same inputs:
   the HMC-family modes bit for bit, NUTS (at each width, with the
   checkpoint stacks in shared and in global memory) by the chains whose
   tree or proposal differs (their sums are added in another order);
3. unless ``--quick``, times each at the main paths' shapes, back to back
   (CUDA events over 50 launches) and replayed from a CUDA graph (the
   device alone), the earlier kernel and the current ones in turns
   (earlier, current..., earlier).

Prints one JSON object (and writes it to ``--out`` when given). With
``--clocks`` it builds the current sources with ``-DZS_NUTS_CLOCKS`` and
``-DZS_HMC_CLOCKS`` and adds the cycles that lane 0 of block 0 spends in
each part of its NUTS leaf and of its HMC sub-step (``clock64`` stamps);
``--sass-dir`` writes the SASS of the main shape's kernels there;
``--parent-clocks DIR`` times the parts of an instrumented copy of the
earlier NUTS kernel the same way; ``--variant NAME=DIR`` (repeatable) times
copies of the current NUTS source with one change each, beside it, in
turns (current, variants..., current).
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
from zhusuan_tpu_torch.ops import _build  # noqa: E402
from zhusuan_tpu_torch.ops import chees_step, hmc_step, leapfrog, nuts_step  # noqa: E402
from zhusuan_tpu_torch.ops._launch import current_stream_pointer  # noqa: E402

C_NUTS, DIM = 4096, 100
NUTS_CASES = ((6, 1.0), (8, 30.0), (10, 30.0))  # depth, std max
REPS = 50
# The NUTS widths timed beside the one the kernel takes at d = 100 (8).
OTHER_NUTS_LANES = (16, 32)
# The kernels whose SASS --sass-dir keeps: the NUTS kernel at d = 100 (the
# earlier K = 1, the current 8 lanes x 4 groups) and K7 on the
# equicorrelated density at d = 100 (K = 1).
SASS_KEEP = (r"fused_nuts_kernelILi1EE|fused_nuts_kernelILi8ELi4E|"
             r"hmc_family_kernelILi1EfN2zs22EquicorrelatedGaussianELi1EE")


def _nvcc_build(src, out, defines=()):
    flags = list(_build.NVCC_FLAGS) + ["-fmad=false"] + list(defines)
    res = subprocess.run([_build._nvcc(), *flags, "-o", out, src],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed on {}:\n{}{}".format(
            src, res.stdout, res.stderr))
    return [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
            if "registers" in ln or "spill" in ln]


_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|(0x[0-9a-f]+)")


def sass_loops(lib_path, pattern):
    """``{function: {"instructions", "loops": [...]}}`` for the kernels
    whose mangled name matches ``pattern``."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for block in text.split("Function : ")[1:]:
        name = block.split()[0]
        if not re.search(pattern, name):
            continue
        insns, labels, pending = [], {}, []
        for line in block.splitlines():
            m = _LABEL.match(line)
            if m:
                pending.append(m.group(1))
                continue
            m = _INSN.search(line)
            if m:
                addr = int(m.group(1), 16)
                for lab in pending:
                    labels[lab] = addr
                pending = []
                insns.append((addr, m.group(2)))
        loops = []
        for addr, text_ in insns:
            if "BRA" not in text_.split()[0] and "BRA" not in text_:
                continue
            m = _TARGET.search(text_.split("BRA", 1)[1])
            if not m:
                continue
            target = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
            if target is None or target > addr:
                continue
            body = [t for a, t in insns if target <= a <= addr]
            loops.append({"head": target, "branch": addr,
                          "instructions": len(body),
                          "shfl": sum("SHFL" in t for t in body),
                          "mufu": sum("MUFU" in t for t in body),
                          "shared": sum(("LDS" in t or "STS" in t)
                                        for t in body),
                          "global": sum(bool(re.search(r"\b(LDG|STG|LD|ST)\b", t))
                                        for t in body)})
        loops.sort(key=lambda r: -r["instructions"])
        out[name] = {"instructions": len(insns), "loops": loops[:6]}
    return out


def _nuts_entry(lib):
    """Type the current C entry of a NUTS library built here."""
    ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    lib.zs_fused_nuts_transition.argtypes = (
        [ptr] * 9 + [i32, i32, i32, ctypes.c_float, u32, u32, u32]
        + [ptr] * 10)
    lib.zs_fused_nuts_transition.restype = i32
    return lib


def _nuts_outputs(c, dev, q):
    return [torch.empty_like(q)] + [torch.empty(c, device=dev)
                                    for _ in range(3)] + [
        torch.empty(c, dtype=torch.int32, device=dev) for _ in range(2)] + [
        torch.empty(c, dtype=torch.bool, device=dev) for _ in range(2)]


def nuts_call(lib, dens, q, inv_mass, depth, key, noise, shared, outs=None):
    """A closure launching the current NUTS C entry of ``lib`` (returns the
    outputs), with the checkpoint stacks in shared memory or in a scratch
    buffer."""
    c, d = q.shape
    dev = q.device
    loc, inv_var = dens.kernel_args(dev)
    ss = torch.full((1,), 0.1, device=dev)
    out = outs if outs is not None else _nuts_outputs(c, dev, q)
    nz = [None] * 4 if noise is None else [v.data_ptr() for v in noise]
    stacks = None if shared else torch.empty(
        (c + 3) * 2 * max(depth - 1, 1) * (-(-d // 4)) * 4, device=dev)

    def run():
        rc = lib.zs_fused_nuts_transition(
            q.data_ptr(), inv_mass.data_ptr(), loc.data_ptr(),
            inv_var.data_ptr(), ss.data_ptr(), *nz, c, d, depth, 1000.0,
            key[0], key[1], 1, None if shared else stacks.data_ptr(),
            *[v.data_ptr() for v in out], current_stream_pointer(0))
        if rc != 0:
            raise RuntimeError("NUTS kernel: CUDA error {}".format(rc))
        return out
    return run


def _sync_ms(fn, reps=REPS):
    return cs._time_ms(torch, fn, reps)


def _graph(fn):
    return cs._graph_ms(torch, fn, 20)


class Parent:
    """The earlier libraries through their own C entries."""

    def __init__(self, d, tmp):
        self.paths, self.ptxas = {}, {}
        for name in ("nuts_step", "hmc_step"):
            src = os.path.join(d, name + ".cu")
            out = os.path.join(tmp, "parent_" + name + ".so")
            self.ptxas[name] = _nvcc_build(src, out)
            self.paths[name] = out
        ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        self.nuts = ctypes.CDLL(self.paths["nuts_step"])
        self.nuts.zs_fused_nuts_transition.argtypes = (
            [ptr] * 9 + [i32, i32, i32, ctypes.c_float, u32, u32, u32]
            + [ptr] * 9)
        self.hmc = ctypes.CDLL(self.paths["hmc_step"])
        self.hmc.zs_fused_hmc_step.argtypes = (
            [ptr, i32, ptr, i32, ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
             u32, u32, u32] + [ptr] * 8)
        self.hmc.zs_fused_chees_step.argtypes = (
            [ptr, ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, u32, u32,
             u32] + [ptr] * 7)
        self.hmc.zs_fused_leapfrog.argtypes = (
            [ptr, ptr, ptr, i32, i32, ptr, ptr, ptr, i32, i32, i32]
            + [ptr] * 3)

    @staticmethod
    def _check(rc):
        if rc != 0:
            raise RuntimeError("earlier kernel: CUDA error {}".format(rc))

    def nuts_fn(self, dens, q, inv_mass, depth, key, noise=None):
        c, d = q.shape
        dev = q.device
        loc, inv_var = dens.kernel_args(dev)
        ss = torch.full((1,), 0.1, device=dev)
        out = (torch.empty_like(q),) + tuple(
            torch.empty(c, device=dev) for _ in range(3)) + tuple(
            torch.empty(c, dtype=torch.int32, device=dev) for _ in range(2)) \
            + tuple(torch.empty(c, dtype=torch.bool, device=dev)
                    for _ in range(2))
        nz = [None] * 4 if noise is None else [v.data_ptr() for v in noise]

        def run():
            self._check(self.nuts.zs_fused_nuts_transition(
                q.data_ptr(), inv_mass.data_ptr(), loc.data_ptr(),
                inv_var.data_ptr(), ss.data_ptr(), *nz, c, d, depth, 1000.0,
                key[0], key[1], 1, *[v.data_ptr() for v in out],
                current_stream_pointer(0)))
            return out
        return run

    def family_fn(self, mode, dens, q, mass, n, p=None):
        c, d = q.shape
        dev = q.device
        kid, p0, p1 = hmc_step.density_pointers(dens, dev)
        ss = torch.full((1,), 0.2, device=dev)
        if mode == "chees":
            n_dev = torch.tensor(n, dtype=torch.int32, device=dev)
            out = [torch.empty(c, d, device=dev) for _ in range(3)] + [
                torch.empty(c, device=dev) for _ in range(3)]

            def run():
                self._check(self.hmc.zs_fused_chees_step(
                    q.data_ptr(), mass.data_ptr(), kid, p0, p1, ss.data_ptr(),
                    n_dev.data_ptr(), None, None, c, d, 3, 4, 1,
                    *[v.data_ptr() for v in out], current_stream_pointer(0)))
                return out
        elif mode == "step":
            out = [torch.empty_like(q), torch.empty(c, d, device=dev)] + [
                torch.empty(c, device=dev) for _ in range(5)]

            def run():
                self._check(self.hmc.zs_fused_hmc_step(
                    q.data_ptr(), int(q.dtype == torch.bfloat16),
                    mass.data_ptr(), kid, p0, p1, ss.data_ptr(), None, None,
                    c, d, n, 3, 4, 1, *[v.data_ptr() for v in out],
                    current_stream_pointer(0)))
                return out
        else:
            out = [torch.empty_like(q), torch.empty_like(q)]

            def run():
                self._check(self.hmc.zs_fused_leapfrog(
                    q.data_ptr(), p.data_ptr(), mass.data_ptr(),
                    int(mass.shape[0] != 1), kid, p0, p1, ss.data_ptr(), c, d,
                    n, *[v.data_ptr() for v in out],
                    current_stream_pointer(0)))
                return out
        return run


def current_family_fn(mode, dens, q, mass, n, p=None):
    if mode == "chees":
        n_dev = torch.tensor(n, dtype=torch.int32, device=q.device)
        return lambda: chees_step.fused_chees_step(dens, q, mass, 0.2, n_dev,
                                                   (3, 4), 1)
    if mode == "step":
        return lambda: hmc_step.fused_hmc_step(dens, q, mass, 0.2, n, (3, 4),
                                               1)
    return lambda: leapfrog.fused_leapfrog(dens, q, p, 0.2, n, mass)


FAMILY_CASES = (
    # (label, mode, density, chains, dim, n leapfrogs, unit mass)
    ("K7 chees equicorrelated n190", "chees", "equicorrelated", 4096, DIM,
     190, True),
    ("K7 chees diagonal n190", "chees", "diagonal", 4096, DIM, 190, True),
    ("K1 step diagonal n5", "step", "diagonal", 32768, DIM, 5, False),
    ("K1 step equicorrelated n5", "step", "equicorrelated", 4096, DIM, 5,
     False),
    ("K2 trajectory equicorrelated n5", "trajectory", "equicorrelated", 4096,
     DIM, 5, False),
    # A row a warp leaves mostly idle: 10 groups of 4.
    ("K7 chees equicorrelated n190 d37", "chees", "equicorrelated", 4096, 37,
     190, True),
    ("K1 step diagonal n5 d37", "step", "diagonal", 32768, 37, 5, False),
)


def family(parent, quick):
    dev = torch.device("cuda", 0)
    rec = {}
    for label, mode, density, c, d, n, unit in FAMILY_CASES:
        dens, q, mass, noise = cs._family_problem(torch, dev, c, d, density,
                                                  7, unit_mass=unit)
        p = noise[0]
        old = parent.family_fn(mode, dens, q, mass, n, p)
        want = [v.clone() for v in old()]
        new = current_family_fn(mode, dens, q, mass, n, p)
        got = new()
        torch.cuda.synchronize()
        r = {"bit_identical_to_earlier": all(
            torch.equal(a, b) for a, b in zip(got, want))}
        if not quick:
            r["earlier_ms"] = [_sync_ms(old)]
            r["earlier_graph_ms"] = [_graph(old)]
            r["ms"] = _sync_ms(new)
            r["graph_ms"] = _graph(new)
            r["earlier_ms"].append(_sync_ms(old))
            r["earlier_graph_ms"].append(_graph(old))
        rec[label] = r
    return rec


def nuts(parent, widths, quick):
    """The current kernel at its own width (``nuts_step.nuts_lanes``) and at
    ``widths`` (``{lanes: library}``), stacks in shared and in global
    memory, beside the earlier kernel."""
    dev = torch.device("cuda", 0)
    from zhusuan_tpu_torch.mcmc.nuts import draw_noise

    libs = {nuts_step.nuts_lanes(DIM): nuts_step.kernel_library()[0],
            **widths}
    rec = {}
    for depth, std_max in NUTS_CASES:
        dens, q, inv_mass = cs._nuts_problem(torch, dev, C_NUTS, DIM, std_max, 7)
        noise = draw_noise(torch.Generator(device=dev).manual_seed(depth),
                           C_NUTS, DIM, depth, torch.float32, dev)
        want = [v.clone() for v in parent.nuts_fn(dens, q, inv_mass, depth,
                                                  (3, 4), noise)()]
        r = {"layouts": {}, "chosen": list(nuts_step.nuts_layout(
            DIM, depth, C_NUTS)),
             "leapfrogs_total": int(want[5].sum()),
             "mean_depth": float(want[4].float().mean())}
        fns = {}
        for lanes, lib in libs.items():
            for shared in (True, False):
                key = "L{}_{}".format(lanes, "shared" if shared else "global")
                got = nuts_call(lib, dens, q, inv_mass, depth, (3, 4), noise,
                                shared)()
                torch.cuda.synchronize()
                diff = ~((got[4] == want[4]) & (got[5] == want[5])
                         & (got[6] == want[6]) & (got[7] == want[7])
                         & ((got[0] - want[0]).abs().amax(1) <= 1e-5 * (
                             1 + want[0].abs().amax(1))))
                r["layouts"][key] = {
                    "chains_differing_from_earlier": int(diff.sum())}
                fns[key] = nuts_call(lib, dens, q, inv_mass, depth, (3, 4),
                                     None, shared)
        if not quick:
            old = parent.nuts_fn(dens, q, inv_mass, depth, (3, 4))
            r["earlier_ms"] = [_sync_ms(old)]
            r["earlier_graph_ms"] = [_graph(old)]
            for key, fn in fns.items():
                r["layouts"][key]["ms"] = _sync_ms(fn)
                r["layouts"][key]["graph_ms"] = _graph(fn)
            r["earlier_ms"].append(_sync_ms(old))
            r["earlier_graph_ms"].append(_graph(old))
            r["bound"] = cs._nuts_bound(C_NUTS, DIM, r["leapfrogs_total"])
        rec["depth%d" % depth] = r
    return rec


def family_clocks(tmp):
    """Cycles per part of lane 0's trajectory (block 0): K7 at 4096 x 100,
    190 leapfrogs, both densities."""
    src = os.path.join(_build.CSRC_DIR, "hmc_step.cu")
    out = os.path.join(tmp, "clocks_hmc_step.so")
    _nvcc_build(src, out, ["-DZS_HMC_CLOCKS"])
    lib = ctypes.CDLL(out)
    lib.zs_hmc_clocks.argtypes = [ctypes.c_void_p]
    ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    lib.zs_fused_chees_step.argtypes = (
        [ptr, ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, u32, u32,
         u32] + [ptr] * 7)
    dev = torch.device("cuda", 0)
    rec = {}
    for density in ("equicorrelated", "diagonal"):
        dens, q, mass, _ = cs._family_problem(torch, dev, 4096, DIM, density,
                                              7, unit_mass=True)
        kid, p0, p1 = hmc_step.density_pointers(dens, dev)
        ss = torch.full((1,), 0.2, device=dev)
        n_dev = torch.tensor(190, dtype=torch.int32, device=dev)
        outs = [torch.empty(4096, DIM, device=dev) for _ in range(3)] + [
            torch.empty(4096, device=dev) for _ in range(3)]
        rc = lib.zs_fused_chees_step(
            q.data_ptr(), mass.data_ptr(), kid, p0, p1, ss.data_ptr(),
            n_dev.data_ptr(), None, None, 4096, DIM, 3, 4, 1,
            *[v.data_ptr() for v in outs], current_stream_pointer(0))
        torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError("clocks build: CUDA error {}".format(rc))
        host = (ctypes.c_longlong * 4)()
        lib.zs_hmc_clocks(host)
        rec["K7_" + density] = dict(
            zip(("total", "drifts", "gradients", "kicks"), list(host)))
    return rec


def clocks(tmp):
    """Cycles per part of lane 0's tree (block 0), depths 6, 8, 10, at the
    kernel's own width, stacks in shared memory."""
    src = os.path.join(_build.CSRC_DIR, "nuts_step.cu")
    out = os.path.join(tmp, "clocks_nuts_step.so")
    _nvcc_build(src, out, ["-DZS_NUTS_CLOCKS"])
    lib = _nuts_entry(ctypes.CDLL(out))
    lib.zs_nuts_clocks.argtypes = [ctypes.c_void_p]
    lib.zs_nuts_clocks.restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    rec = {}
    for depth, std_max in NUTS_CASES:
        dens, q, inv_mass = cs._nuts_problem(torch, dev, C_NUTS, DIM, std_max, 7)
        outs = nuts_call(lib, dens, q, inv_mass, depth, (3, 4), None, True)()
        torch.cuda.synchronize()
        host = (ctypes.c_longlong * 8)()
        lib.zs_nuts_clocks(host)
        names = ("total", "leaves", "uniforms", "leapfrog", "sums",
                 "butterfly", "decisions", "merges")
        rec["depth{}_L{}".format(depth, nuts_step.nuts_lanes(DIM))] = dict(
            zip(names, list(host)), n_leapfrogs_chain0=int(outs[5][0]))
    return rec


def variants(specs, tmp):
    """``{name: {depth_stacks: [graph ms, ...]}}`` for copies of the current
    ``nuts_step.cu`` (same C entry), each ``name=DIR`` built from
    ``DIR/nuts_step.cu``, beside the current build, with the stacks in
    shared and in global memory."""
    libs = {"current": nuts_step.kernel_library()[0]}
    for spec in specs:
        name, d = spec.split("=", 1)
        out = os.path.join(tmp, "variant_{}.so".format(name))
        _nvcc_build(os.path.join(d, "nuts_step.cu"), out)
        libs[name] = _nuts_entry(ctypes.CDLL(out))
    dev = torch.device("cuda", 0)
    rec = {name: {} for name in libs}
    for depth, std_max in NUTS_CASES:
        dens, q, inv_mass = cs._nuts_problem(torch, dev, C_NUTS, DIM, std_max, 7)
        for shared in (True, False):
            key = "depth{}_{}".format(depth, "shared" if shared else "global")
            for name, lib in list(libs.items()) + [("current", libs["current"])]:
                run = nuts_call(lib, dens, q, inv_mass, depth, (3, 4), None,
                                shared)
                rec[name].setdefault(key, []).append(_graph(run))
    return rec


def parent_clocks(d, tmp):
    """The same stamps in an instrumented copy of the earlier NUTS kernel
    (``d/nuts_step.cu`` defining ``zs_nuts_clocks``; a warp a chain): 0 the
    kernel, 1 the leaves, 2 the leaf uniform and the selection, 3 the
    leapfrog, 4 the energies with their butterfly, 6 the U-turn checks."""
    out = os.path.join(tmp, "parent_clocks_nuts_step.so")
    _nvcc_build(os.path.join(d, "nuts_step.cu"), out)
    lib = ctypes.CDLL(out)
    lib.zs_nuts_clocks.argtypes = [ctypes.c_void_p]
    ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    lib.zs_fused_nuts_transition.argtypes = (
        [ptr] * 9 + [i32, i32, i32, ctypes.c_float, u32, u32, u32]
        + [ptr] * 9)
    dev = torch.device("cuda", 0)
    rec = {}
    for depth, std_max in NUTS_CASES:
        dens, q, inv_mass = cs._nuts_problem(torch, dev, C_NUTS, DIM, std_max, 7)
        loc, inv_var = dens.kernel_args(dev)
        ss = torch.full((1,), 0.1, device=dev)
        c = C_NUTS
        outs = [torch.empty_like(q)] + [torch.empty(c, device=dev)
                                        for _ in range(3)] + [
            torch.empty(c, dtype=torch.int32, device=dev) for _ in range(2)] \
            + [torch.empty(c, dtype=torch.bool, device=dev) for _ in range(2)]
        rc = lib.zs_fused_nuts_transition(
            q.data_ptr(), inv_mass.data_ptr(), loc.data_ptr(),
            inv_var.data_ptr(), ss.data_ptr(), None, None, None, None, c, DIM,
            depth, 1000.0, 3, 4, 1, *[v.data_ptr() for v in outs],
            current_stream_pointer(0))
        torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError("earlier clocks build: CUDA error {}".format(rc))
        host = (ctypes.c_longlong * 8)()
        lib.zs_nuts_clocks(host)
        names = ("total", "leaves", "uniform_and_selection", "leapfrog",
                 "energies_and_butterfly", "-", "u_turn_checks", "-")
        rec["depth%d" % depth] = {n: v for n, v in zip(names, list(host))
                                  if n != "-"}
        rec["depth%d" % depth]["n_leapfrogs_chain0"] = int(outs[5][0])
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--clocks", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--sass-dir", help="write each library's SASS here")
    ap.add_argument("--parent-clocks", help="an instrumented earlier csrc")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=DIR: time DIR/nuts_step.cu beside the current")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    tmp = tempfile.mkdtemp()
    try:
        libs = _build.build_libraries(["hmc_step", "nuts_step"])
        parent = Parent(args.parent, tmp)
        rec = {"card": out, "torch": torch.__version__,
               "cuda": torch.version.cuda,
               "nvcc": subprocess.run([_build._nvcc(), "--version"],
                                      capture_output=True,
                                      text=True).stdout.strip().splitlines()[-1]}
        rec["ptxas"] = {
            "current": {n: [ln.strip() for ln in r["log"].splitlines()
                            if "registers" in ln or "spill" in ln]
                        for n, (_, r) in libs.items()},
            "earlier": parent.ptxas}
        rec["sass"] = {
            "earlier_nuts": sass_loops(parent.paths["nuts_step"],
                                       "fused_nuts_kernel"),
            "current_nuts": sass_loops(libs["nuts_step"][1]["path"],
                                       "fused_nuts_kernel"),
            "earlier_chees": sass_loops(parent.paths["hmc_step"],
                                        r"hmc_family_kernel.*Li1E"),
            "current_chees": sass_loops(libs["hmc_step"][1]["path"],
                                        r"hmc_family_kernel.*Li1E"),
        }
        if args.variant:
            rec["variants"] = variants(args.variant, tmp)
        widths = {}
        for lanes in OTHER_NUTS_LANES:
            out = os.path.join(tmp, "nuts_step_L{}.so".format(lanes))
            _nvcc_build(os.path.join(_build.CSRC_DIR, "nuts_step.cu"), out,
                        ["-DZS_NUTS_LANES={}".format(lanes)])
            widths[lanes] = _nuts_entry(ctypes.CDLL(out))
        rec["family"] = family(parent, args.quick)
        rec["nuts"] = nuts(parent, widths, args.quick)
        if args.clocks:
            rec["clocks"] = clocks(tmp)
            rec["family_clocks"] = family_clocks(tmp)
        if args.parent_clocks:
            rec["earlier_clocks"] = parent_clocks(args.parent_clocks, tmp)
        if args.sass_dir:
            os.makedirs(args.sass_dir, exist_ok=True)
            for label, path in (("earlier", parent.paths["nuts_step"]),
                                ("current", libs["nuts_step"][1]["path"]),
                                ("earlier", parent.paths["hmc_step"]),
                                ("current", libs["hmc_step"][1]["path"])):
                cuobjdump = os.path.join(os.path.dirname(_build._nvcc()),
                                         "cuobjdump")
                text = subprocess.run([cuobjdump, "-sass", path],
                                      capture_output=True, text=True).stdout
                text = "".join(
                    "Function : " + blk
                    for blk in text.split("Function : ")[1:]
                    if re.search(SASS_KEEP, blk.split()[0]))
                name = "{}_{}.sass".format(
                    label, os.path.basename(path).split("-")[0].split(".")[0])
                with open(os.path.join(args.sass_dir, name), "w") as f:
                    f.write(text)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    text = json.dumps(rec)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text)


if __name__ == "__main__":
    main()
