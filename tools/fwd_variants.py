"""Time design variants of the wide-head forward kernel,
flash_fwd_cluster_kernel, against the kernel itself on one CUDA card, at
chip_smoke.py's WIDE_SHAPES: (8, 2304, 512), the local-global heads'
(8, 576, 512), and (16, 2304, 256).

    python3 tools/fwd_variants.py

Each variant is ``edsnet_torch/csrc/flash_attention_fwd.cu`` with one design
choice of the cluster kernel undone by text substitution (``VARIANTS``).
Every variant is built into a library of its own (one nvcc each, all
started together), checked against the plain twin (out and m within 1e-4
at "highest", out and m + log l within 2^-8 at "default") and timed in
CUDA events at both precisions, in the order: the kernel, each variant,
each variant again in reverse order, the kernel.  Times are printed beside
the card's name and power limit.  Exits 1 if a variant does not build,
launch or agree, and 2 without a CUDA card.
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

SOURCE = "flash_attention_fwd"

_INIT = """  if (tid == 0) {
    barrier_init(full);
    barrier_init(empty);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    barrier_expect(full, L::kXBytes);
    barrier_expect(empty, L::kTokenBytes);
  }
  cluster_sync();"""
_SEND = """    if (j > 0) {
      barrier_wait(empty, (j - 1) & 1);
      if (tid == 0) barrier_expect(empty, L::kTokenBytes);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      store_async(peer_xs + 16u * nt * THREADS, s[nt], peer_full);
    barrier_wait(full, j & 1);
    if (tid == 0) barrier_expect(full, L::kXBytes);"""
_TOKEN = """    store_async(peer_token, __float_as_uint(s[0][0]), peer_empty);"""
_END = """  barrier_wait(empty, (n_tiles - 1) & 1);"""
_WAIT = 'asm volatile("barrier.cluster.wait.aligned;" ::: "memory");'


def _cluster_barrier(drain: bool):
    """The exchange through the cluster barrier, split in arrive (release)
    and wait (acquire) (phase A: both partials in place; B: both read),
    with plain remote stores (st.shared::cluster) into a single slot;
    ``drain`` first waits for every copy in flight."""
    arrive = 'asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");'
    first = "tf32::cp_async_wait<0>();\n    " if drain else ""
    return [
        (_INIT, f"  {arrive}  // B: this block runs"),
        (_SEND, f"""    {first}{_WAIT}  // B: the peer has read the last
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      asm volatile("st.shared::cluster.v4.f32 [%0], {{%1, %2, %3, %4}};"
                   ::"r"(peer_xs + 16u * nt * THREADS), "f"(s[nt][0]),
                   "f"(s[nt][1]), "f"(s[nt][2]), "f"(s[nt][3]) : "memory");
    {arrive}  // A
    {_WAIT}"""),
        (_TOKEN, f"    {arrive}  // B"),
        (_END, f"  {_WAIT}")]


# name -> (what it changes, substitutions)
VARIANTS = {
    "cluster_barrier": ("the exchange through barrier.cluster arrive "
                        "(release) and wait (acquire), two phases a key "
                        "tile", _cluster_barrier(drain=False)),
    "cluster_barrier_drained": (
        "the same, the ring's copies in flight awaited before each "
        "exchange", _cluster_barrier(drain=True)),
    "two_blocks": ("four mask slots, 77 KB a block at DH 128, so two blocks "
                   "per SM there (three as built)", [
        ("static constexpr int MSLOTS = 2;", "static constexpr int MSLOTS = 4;"),
        ("__launch_bounds__(THREADS, DH == 128 ? 3 : 2)",
         "__launch_bounds__(THREADS, 2)")]),
}


def variant_source(src: str, name: str) -> str:
    for old, new in VARIANTS[name][1]:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: the kernel source changed; update "
                             f"VARIANTS ({old.strip()[:60]!r})")
        src = src.replace(old, new)
    return src


def build_variants(tmp: Path):
    """{name: the variant's C entry point}, built in parallel; prints each
    cluster instance's registers and spills."""
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
            if kernel.startswith("flash_fwd_cluster_kernel"):
                print(f"  {name}: {kernel}: {regs} registers, {spills}")
        fn = ctypes.CDLL(str(tmp / name / "lib.so")).edsnet_flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("fwd_variants: no CUDA device", file=sys.stderr)
        return 2
    smi = chip_smoke.nvidia_smi()
    print(f"device: {smi}")
    build.build(SOURCE)
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        entries = build_variants(Path(tmp))
        for label, (bh, n, d, lens, seed) in chip_smoke.WIDE_SHAPES.items():
            args = chip_smoke.flash_case(flash, bh, n, d, lens, seed=seed)
            want = flash.flash_attention_plain(*args)
            for precision, tol in chip_smoke.TOLS.items():
                passes = flash.PASSES[precision]

                def call(name):
                    if name == "kernel":
                        return flash.flash_attention_fwd(*args,
                                                         precision=precision)
                    out = torch.empty_like(args[0])
                    m = torch.empty((bh, n, 1), device=out.device)
                    l = torch.empty_like(m)
                    err = entries[name](
                        *(t.data_ptr() for t in (*args, out, m, l)), bh, n, d,
                        passes, d ** -0.5,
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise SystemExit(f"{name}: launch failed, cudaError "
                                         f"{err}")
                    return out, m, l

                names = list(VARIANTS)
                times = {}
                for name in ["kernel", *names, *names[::-1], "kernel"]:
                    errs = chip_smoke.forward_errors(call(name), want)
                    key = "m" if precision == "highest" else "m + log l"
                    if errs["out"] > tol or errs[key] > tol:
                        failed.append(f"{name} {label} {precision}: {errs}")
                    times.setdefault(name, []).append(chip_smoke.cuda_ms(
                        lambda: call(name), iters=100 if n < 1024 else 20))
                base = sum(times["kernel"]) / 2
                for name, ms in times.items():
                    what = VARIANTS[name][0] if name in VARIANTS else "as built"
                    mean = sum(ms) / 2
                    print(f"  [{smi}] {label} {(bh, n, d)} {precision}, "
                          f"{name} ({what}): "
                          f"{' / '.join(f'{t:.4f}' for t in ms)} ms "
                          f"({100 * (mean / base - 1):+.1f} %)")
    if failed:
        print(f"FAILED: {failed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
