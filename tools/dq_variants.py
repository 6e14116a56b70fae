"""Time design variants of the dq flash-attention kernel against the kernel
itself on one CUDA card, at the main path's largest shape (BH, N, D) =
(32, 2304, 128).

    python3 tools/dq_variants.py

Each variant is ``edsnet_torch/csrc/flash_attention_bwd.cu`` with one design
choice of the dq kernel undone by text substitution (``VARIANTS``).  Every
variant is built into a library of its own (one nvcc each, all started
together), checked against the plain twin (1e-4 at "highest", 2^-8 at
"default", times max(1, max |want|)) and timed in CUDA events, per pass
count, in the order: the kernel, each variant, each variant again in
reverse order, the kernel.  Times are printed beside the card's name and
power limit.  Exits 1 if a variant does not build, launch or agree, and 2
without a CUDA card.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from edsnet_torch.kernels import build  # noqa: E402
from edsnet_torch.kernels import flash_attention as flash  # noqa: E402

SOURCE = "flash_attention_bwd"
SHAPE = (32, 2304, 128)

_G_ROUNDED = "tf32::load_a_rounded<PASSES>(gw + 8 * kk, L::kG, LD, gq, t)"
_K_BT_ROUNDED = """tf32::load_bt_rounded<PASSES>(
                                         ks + off, k_small, LD, gq, t)"""
_K_B_ROUNDED = """tf32::load_b_renamed_rounded<PASSES>(
                                            kk_rows + 8 * dt, k_small, LD, gq,
                                            t)"""
_ROUND_G_AND_K = """    if (j == 0)
      tf32::round_rows<PASSES, D, DQ_THREADS>(gs, LD, L::kG, DQ_BQ, tid);
    tf32::round_rows<PASSES, D, DQ_THREADS>(ks, LD, k_small, BK, tid);"""

# name -> (TF32 passes it is timed at, what it changes, substitutions)
VARIANTS = {
    "per_use": ((3, 1), "every operand split at each fragment load, as the "
                        "forward and dk/dv kernels split theirs", [
        ("qa[kk][i] = kOnePass ? __uint_as_float(tf32::cvt_rna(x[i])) "
         ": x[i];", "qa[kk][i] = x[i];"),
        ("""    if constexpr (kOnePass)
      return tf32::as_rounded(qa[kk]);
    else
      return tf32::split<PASSES>(qa[kk]);""",
         "    return tf32::split<PASSES>(qa[kk]);"),
        (_ROUND_G_AND_K, ""),
        (_G_ROUNDED, "tf32::load_a<PASSES>(gw + 8 * kk, LD, gq, t)"),
        (_K_BT_ROUNDED, "tf32::load_bt<PASSES>(ks + off, LD, gq, t)"),
        (_K_B_ROUNDED,
         "tf32::load_b_renamed<PASSES>(kk_rows + 8 * dt, LD, gq, t)")]),
    "v_once": ((1,), "v rounded once per tile too, in place (one pass "
                      "only)", [
        ("    const float* vs = ks + L::kKV;", "    float* vs = ks + L::kKV;"),
        (_ROUND_G_AND_K, _ROUND_G_AND_K + """
    tf32::round_rows<PASSES, D, DQ_THREADS>(vs, LD, 0, BK, tid);"""),
        ("tf32::load_bt<PASSES>(vs + off, LD, gq, t)",
         "tf32::load_bt_rounded<PASSES>(vs + off, 0, LD, gq, t)")]),
    "g_per_use": ((3,), "g split at each use at three passes, as q is", [
        ("    if (j == 0)\n", "    if (kOnePass && j == 0)\n"),
        (_G_ROUNDED, "tf32::load_a<PASSES>(gw + 8 * kk, LD, gq, t)")]),
    "bk16": ((1,), "16-key tiles at one pass", [
        ("return PASSES == 1 ? 32 : 16;", "return 16;")]),
    "bk32": ((3,), "32-key tiles at three passes (one block per SM)", [
        ("return PASSES == 1 ? 32 : 16;", "return 32;")]),
}


def variant_source(src: str, name: str) -> str:
    for old, new in VARIANTS[name][2]:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: the kernel source changed; update "
                             f"VARIANTS ({old.strip()[:60]!r})")
        src = src.replace(old, new)
    return src


def build_variants(tmp: Path):
    """{name: the variant's C entry point}, built in parallel; prints each
    dq instance's registers and spills."""
    procs = {}
    for name in VARIANTS:
        csrc = tmp / name
        shutil.copytree(build.SRC_DIR, csrc)
        path = csrc / f"{SOURCE}.cu"
        path.write_text(variant_source(path.read_text(), name))
        cmd = [build.nvcc_path(), *build.ARCH_FLAGS, "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-o", str(csrc / "lib.so"), str(path)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    entries = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        for kernel, spills, regs in chip_smoke.ptxas_summary(log):
            if kernel.startswith("flash_dq_kernel<128"):
                print(f"  {name}: {kernel}: {regs} registers, {spills}")
        fn = ctypes.CDLL(str(tmp / name / "lib.so")).edsnet_flash_attention_dq
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("dq_variants: no CUDA device", file=sys.stderr)
        return 2
    smi = chip_smoke.nvidia_smi()
    print(f"device: {smi}")
    build.build(SOURCE)
    bh, n, d = SHAPE
    q, k, v, mask = chip_smoke.flash_case(flash, bh, n, d, [n] * bh, seed=9)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(9)
                    ).cuda()
    out, m, l = flash.flash_attention_plain(q, k, v, mask)
    args = (q, k, v, mask, g, m, l, (g * out).sum(-1, keepdim=True))
    want = flash.flash_attention_dq_plain(*args)
    limit = max(1.0, float(want.abs().max()))
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        entries = build_variants(Path(tmp))
        for precision in ("highest", "default"):
            passes = flash.PASSES[precision]

            def call(name):
                if name == "kernel":
                    return flash.flash_attention_dq(*args,
                                                    precision=precision)
                dq = torch.empty_like(q)
                err = entries[name](*(t.data_ptr() for t in args),
                                    dq.data_ptr(), bh, n, d, passes,
                                    d ** -0.5,
                                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise SystemExit(f"{name}: launch failed, cudaError {err}")
                return dq

            names = [name for name, (at, _, _) in VARIANTS.items()
                     if passes in at]
            times = {}
            for name in ["kernel", *names, *names[::-1], "kernel"]:
                err = float((call(name) - want).abs().max())
                if err > chip_smoke.TOLS[precision] * limit:
                    failed.append(f"{name} at {precision}: error {err:.3e}")
                times.setdefault(name, []).append(
                    chip_smoke.cuda_ms(lambda: call(name)))
            base = min(times["kernel"])
            for name, ms in times.items():
                what = VARIANTS[name][1] if name in VARIANTS else "as built"
                print(f"  [{smi}] dq {SHAPE} {precision}, {name} ({what}): "
                      f"{' / '.join(f'{t:.4f}' for t in ms)} ms "
                      f"({100 * (min(ms) / base - 1):+.1f} %)")
    if failed:
        print(f"FAILED: {failed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
