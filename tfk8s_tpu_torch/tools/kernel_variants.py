"""Time variants of the port's CUDA kernels against the shipped ones, on
the card, in one process.

    python -m tfk8s_tpu_torch.tools.kernel_variants

It is the script behind the variant timings in ``PERF.md``. A variant is
a copy of a kernel source under ``build/variants/`` with exact text
replacements (each must match the source once, else it raises), built with
the port's ``nvcc`` flags and ``-Xptxas -v``, one ``nvcc`` per variant,
all started together, and loaded with ctypes beside the shipped library.
Its entry point runs on the same card tensors as the shipped kernel, is
checked against it (the copy bit for bit; dq within the bf16 flash
tolerance of the plain version), and both are timed with CUDA events in
turns (shipped, variant, variant, shipped; ``ROUNDS`` times), so that
they see the same card and the same host. One JSON line per variant, and
ptxas's registers and spills for each dq instantiation.

Sets:
- ``dq``: the tensor-core dq (``flash_attention_sm90.cu``) at the GPT-2-
  small slice (b=8, l=1024, h=12, d=64, causal, bf16) and at d=128 with
  half the heads: dS rounded once to bf16 (the hi + lo split's cost),
  blocks an SM.
- ``copy``: the TMA bulk copy (``block_copy.cu``) at [8192, 8192] f32:
  contiguous runs of chunks a block, no L2 evict-first hints, bytes a
  stage, stages, blocks an SM; beside ``Tensor.copy_``.
- ``gn``: the one-read GroupNorm kernels (``group_norm.cu``) at five
  ResNet-50 norm sites (bfloat16, batch 256): the layout rule's
  preferences (the least bytes a tile holds of a position, the shared
  memory a block takes), each timed forward and backward by profiler
  device time of the bare entry points (no wrapper), in turns, and checked
  against the shipped kernel's output.

    python -m tfk8s_tpu_torch.tools.kernel_variants [SET ...]

runs the named sets (all by default).
"""

from __future__ import annotations

import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from tfk8s_tpu_torch.ops import _build
from tfk8s_tpu_torch.tools.gn_sweep import bound_ms, device_ms, events_ms

VARIANT_DIR = _build.BUILD_DIR.parent / "variants"
ROUNDS = 2

_DQ_BLOCKS = "static constexpr int MIN_BLOCKS = 2;"
_DQ_SPLIT = """    uint32_t da[C::BN / 16][4], db[C::BN / 16][4];  // dS = da + db
    to_a_frags_split<C::BN>(dp, da, db);
    pin(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < C::BN / 16; ++kk) {
      Wgmma<D>::template rs<1>(acc, da[kk], desc_mn<D>(kt, C::BN, kk), 1);
      Wgmma<D>::template rs<1>(acc, db[kk], desc_mn<D>(kt, C::BN, kk), 1);
    }"""
# dS rounded once to bf16, as dk/dv rounds it: the split's cost
_DQ_SINGLE = """    uint32_t da[C::BN / 16][4];
    to_a_frags<C::BN>(dp, da);
    pin(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < C::BN / 16; ++kk)
      Wgmma<D>::template rs<1>(acc, da[kk], desc_mn<D>(kt, C::BN, kk), 1);"""
_COPY_TURNS = """  const int n = (int)((chunks - blockIdx.x + gridDim.x - 1) / gridDim.x);
  auto offset_of = [&](int i) { return (blockIdx.x + (long long)i * gridDim.x) * kChunk; };"""
# each block a contiguous run of chunks
_COPY_RUNS = """  const long long c0 = chunks * blockIdx.x / gridDim.x;
  const int n = (int)(chunks * (blockIdx.x + 1) / gridDim.x - c0);
  auto offset_of = [&](int i) { return (c0 + i) * kChunk; };"""
# no L2 hints: the policy is the default, evict-normal
_COPY_NO_HINTS = {
    'asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));':
        'asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;" : "=l"(policy));',
}


_GN_PREFS = ("constexpr int kPrefs[][2] = {{64, kSmemTwoBlocks}, {32, kSmemTwoBlocks}, "
             "{32, kSmemMax}};")


def _gn_prefs(*prefs: str) -> Dict[str, str]:
    return {_GN_PREFS: "constexpr int kPrefs[][2] = {" + ", ".join(prefs) + "};"}


def _copy_variant(chunk: int, stages: int, blocks: int) -> Dict[str, str]:
    return {"constexpr int kChunk = 16384;": f"constexpr int kChunk = {chunk};",
            "constexpr int kStages = 4;": f"constexpr int kStages = {stages};",
            "constexpr int kBlocksPerSm = 2;": f"constexpr int kBlocksPerSm = {blocks};"}


# set -> (source, {variant name: {old text: new text}})
VARIANTS: Dict[str, Tuple[str, Dict[str, Dict[str, str]]]] = {
    "dq": ("flash_attention_sm90", {
        "single_rounding": {_DQ_SPLIT: _DQ_SINGLE},
        "blocks_3_at_d64": {_DQ_BLOCKS: "static constexpr int MIN_BLOCKS = D <= 64 ? 3 : 2;"},
        "blocks_1_at_d128": {_DQ_BLOCKS: "static constexpr int MIN_BLOCKS = D <= 64 ? 2 : 1;"},
    }),
    "copy": ("block_copy", {
        "contiguous_runs": {_COPY_TURNS: _COPY_RUNS},
        "no_hints": _COPY_NO_HINTS,
        "no_hints_chunk32k_stages4_blocks1": {**_COPY_NO_HINTS, **_copy_variant(32768, 4, 1)},
        **{f"chunk{c // 1024}k_stages{s}_blocks{b}": _copy_variant(c, s, b)
           for c, s, b in ((32768, 4, 1), (65536, 3, 1), (16384, 8, 1), (4096, 16, 2),
                           (16384, 3, 4))},
    }),
    "gn": ("group_norm", {
        "tile32": _gn_prefs("{32, kSmemTwoBlocks}", "{32, kSmemMax}"),
        "tile128": _gn_prefs("{128, kSmemTwoBlocks}", "{64, kSmemTwoBlocks}",
                             "{32, kSmemTwoBlocks}", "{32, kSmemMax}"),
        "smem75k": _gn_prefs("{64, 75 * 1024}", "{64, kSmemTwoBlocks}", "{32, kSmemTwoBlocks}",
                             "{32, kSmemMax}"),
        "fwd512": {"constexpr int kFwdThreads = 256;": "constexpr int kFwdThreads = 512;"},
        "fwd128": {"constexpr int kFwdThreads = 256;": "constexpr int kFwdThreads = 128;"},
        "bwd128": {"constexpr int kBwdThreads = 256;": "constexpr int kBwdThreads = 128;"},
        "bwd512": {"constexpr int kBwdThreads = 256;": "constexpr int kBwdThreads = 512;"},
    }),
}
GN_SITES = (((256, 56, 56, 256), False), ((256, 112, 112, 64), True),
            ((256, 28, 28, 512), False), ((256, 14, 14, 1024), False),
            ((256, 7, 7, 2048), True))


def build_variants(source: str, variants: Dict[str, Dict[str, str]]) -> Dict[str, Tuple[Path, str]]:
    """Write and build every variant of ``csrc/<source>.cu``; returns each
    variant's library path and compiler output."""
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / f"{source}.cu").read_text()
    procs = {}
    for name, edits in variants.items():
        src = text
        for old, new in edits.items():
            if src.count(old) != 1:
                raise ValueError(f"variant {name}: {old!r} matches {src.count(old)} times")
            src = src.replace(old, new)
        cu = VARIANT_DIR / f"{source}-{name}.cu"
        cu.write_text(src)
        lib = cu.with_suffix(".so")
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    out = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        out[name] = (lib, log)
    return out


def ptxas_report(log: str, kernel: str) -> List[str]:
    """``kernel<d>: registers, spills`` for each instantiation in ``log``."""
    lines, entry = [], None
    for line in log.splitlines():
        m = re.search(r"entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        elif entry and kernel in entry and ("registers" in line or "spill" in line):
            d = re.search(r"ILi(\d+)EE", entry)
            lines.append(f"d={d.group(1) if d else '?'}: {line.split(':', 1)[-1].strip()}")
    return lines


def in_turns(shipped, variant, iters: int, rounds: int) -> Tuple[float, float]:
    """Mean ms of each, timed shipped, variant, variant, shipped."""
    a, b = [], []
    for _ in range(rounds):
        a.append(events_ms(shipped, iters))
        b.append(events_ms(variant, iters))
        b.append(events_ms(variant, iters))
        a.append(events_ms(shipped, iters))
    return sum(a) / len(a), sum(b) / len(b)


def run_gn(rounds: int) -> None:
    from tfk8s_tpu_torch.ops import group_norm as gn

    source, variants = VARIANTS["gn"]
    built = build_variants(source, variants)
    libs = {}
    for name, (lib_path, log) in built.items():
        lib = ctypes.CDLL(str(lib_path))
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.tfk8s_group_norm_fwd.argtypes = [P] * 6 + [I] * 4 + [F] + [I] * 2 + [P]
        lib.tfk8s_group_norm_bwd.argtypes = [P] * 9 + [I] * 6 + [P]
        lib.tfk8s_group_norm_cluster_size.argtypes = [I] * 7
        libs[name] = lib
        spills = [ln for ln in log.splitlines() if re.search(r"[1-9]\d* bytes spill", ln)]
        print(json.dumps({"set": "gn", "variant": name, "spill_lines": len(spills)}), flush=True)
    for shape, relu in GN_SITES:
        b, h, w, c = shape
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(torch.bfloat16)
        dy = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        scale, bias = (torch.randn(c, generator=gen, device="cuda") for _ in range(2))
        _, m_s, r_s = gn.group_norm_fwd_cuda(x, scale, bias, 32, relu=relu)
        stream = torch.cuda.current_stream().cuda_stream

        def entry_points(lib, name):
            """Both entry points of one library on the same tensors, with
            no wrapper around them (no allocation, no sum of the partials)."""
            y, dx = torch.empty_like(x), torch.empty_like(x)
            m, r = torch.empty_like(m_s), torch.empty_like(r_s)
            part = torch.empty(2, b, c, device="cuda")

            def fwd():
                rc = lib.tfk8s_group_norm_fwd(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                              y.data_ptr(), m.data_ptr(), r.data_ptr(), b, h * w,
                                              c, 32, 1e-6, int(relu), 1, stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: cudaError {rc}")

            def bwd():
                rc = lib.tfk8s_group_norm_bwd(dy.data_ptr(), x.data_ptr(), scale.data_ptr(),
                                              bias.data_ptr(), m_s.data_ptr(), r_s.data_ptr(),
                                              dx.data_ptr(), part[0].data_ptr(),
                                              part[1].data_ptr(), b, h * w, c, 32, int(relu), 1,
                                              stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: cudaError {rc}")

            return fwd, bwd, y, dx

        ship_fwd, ship_bwd, y_s, dx_s = entry_points(gn._lib(), "shipped")
        ship_fwd()
        ship_bwd()
        for name, lib in libs.items():
            fwd, bwd, y, dx = entry_points(lib, f"variant {name}")
            fwd()
            bwd()
            torch.cuda.synchronize()
            err = max(float((y.float() - y_s.float()).abs().max()),
                      float((dx.float() - dx_s.float()).abs().max()))
            times = {}
            for kind, ship, var in (("fwd", ship_fwd, fwd), ("bwd", ship_bwd, bwd)):
                a, v = [], []
                for _ in range(rounds):
                    a.append(device_ms(ship, 10))
                    v.append(device_ms(var, 10))
                    v.append(device_ms(var, 10))
                    a.append(device_ms(ship, 10))
                times[kind] = (sum(a) / len(a), sum(v) / len(v))
            print(json.dumps({
                "set": "gn", "variant": name, "shape": list(shape), "relu": relu,
                "k": [lib.tfk8s_group_norm_cluster_size(b, h * w, c, 32, 1, d, 16)
                      for d in (0, 1)],
                "shipped_k": [gn.cluster_size(shape, 32, torch.bfloat16, d) for d in (0, 1)],
                "max_abs_diff_vs_shipped": err,
                "shipped_fwd_ms": times["fwd"][0], "variant_fwd_ms": times["fwd"][1],
                "shipped_bwd_ms": times["bwd"][0], "variant_bwd_ms": times["bwd"][1],
                "fwd_bound_ms": bound_ms(x.numel(), 2, False),
                "bwd_bound_ms": bound_ms(x.numel(), 2, True),
            }), flush=True)
        del x, dy


def run_dq(rounds: int) -> None:
    from tfk8s_tpu_torch.ops import flash_attention as fa

    source, variants = VARIANTS["dq"]
    built = build_variants(source, variants)
    logs = _build.build([source], verbose=True)
    if source in logs:
        for line in ptxas_report(logs[source], "tfk8s_dq_wgmma_kernel"):
            print(f"ptxas shipped {line}", flush=True)
    for b, l, h, d in ((8, 1024, 12, 64), (8, 1024, 6, 128)):
        gen = torch.Generator(device="cuda").manual_seed(d)
        q, k, v, do = (torch.randn(b, l, h, d, generator=gen, device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        q = (q.float() / math.sqrt(d)).to(torch.bfloat16)
        o, lse = fa.flash_fwd_cuda(q, k, v, None, True)
        dsum, lse2 = fa.flash_bwd_dsum_cuda(do, o, lse)
        want = fa.flash_bwd_dq_plain(q, k, v, do, o, lse, None, True).float()
        flops = 6 * b * h * d * l * (l + 1) // 2  # three products over the causal pairs
        for name, (lib_path, log) in built.items():
            fn = ctypes.CDLL(str(lib_path)).tfk8s_flash_bwd_dq_wgmma
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            out = torch.empty_like(q)

            def variant():
                rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                        dsum.data_ptr(), lse2.data_ptr(), None, out.data_ptr(), b, l, l, h, d,
                        dsum.shape[1], 1, torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"variant {name}: cudaError {rc}")

            def shipped():
                fa.flash_bwd_dq_wgmma_cuda(q, k, v, do, dsum, lse2, None, True)

            variant()
            torch.cuda.synchronize()
            err = float((out.float() - want).abs().max())
            ok = bool(((out.float() - want).abs() <= 2e-2 + 2 ** -7 * want.abs()).all())
            ship_ms, var_ms = in_turns(shipped, variant, 20, rounds)
            print(json.dumps({
                "set": "dq", "variant": name, "shape": [b, l, h, d], "ok": ok,
                "max_abs_err": err, "shipped_ms": ship_ms, "variant_ms": var_ms,
                "shipped_tflops": flops / ship_ms * 1e-9, "variant_tflops": flops / var_ms * 1e-9,
                "ptxas": ptxas_report(log, "tfk8s_dq_wgmma_kernel"),
            }), flush=True)


def run_copy(rounds: int) -> None:
    from tfk8s_tpu_torch.ops import block_copy as bc

    source, variants = VARIANTS["copy"]
    built = build_variants(source, variants)
    x = torch.randn(8192, 8192, device="cuda")
    ref = torch.empty_like(x)
    gb = 2 * x.numel() * 4 / 1e9
    for name, (lib_path, _) in built.items():
        fn = ctypes.CDLL(str(lib_path)).tfk8s_block_copy
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out = torch.full_like(x, float("nan"))

        def variant():
            rc = fn(x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
                    torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"variant {name}: cudaError {rc}")

        variant()
        torch.cuda.synchronize()
        exact = torch.equal(out, x)
        ship_ms, var_ms = in_turns(lambda: bc.block_copy_cuda(x, ref), variant, 20, rounds)
        _, copy_ms = in_turns(lambda: bc.block_copy_cuda(x, ref), lambda: ref.copy_(x), 20, 1)
        print(json.dumps({
            "set": "copy", "variant": name, "bit_exact": exact, "shipped_ms": ship_ms,
            "variant_ms": var_ms, "copy__ms": copy_ms, "shipped_gbps": gb / ship_ms * 1e3,
            "variant_gbps": gb / var_ms * 1e3,
        }), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device visible", file=sys.stderr)
        return 2
    sets = {"dq": run_dq, "copy": run_copy, "gn": run_gn}
    for name in sys.argv[1:] or list(sets):
        sets[name](ROUNDS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
