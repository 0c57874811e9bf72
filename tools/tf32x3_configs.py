"""Time the fp32 backward flash kernels (``ops/csrc/flash_attention_tf32x3.cu``)
under other block shapes than the one the source fixes, on the card.

    python tools/tf32x3_configs.py            # from the repository root

Each configuration is a copy of the source with ``OWN`` (the rows a block
owns), ``NW`` (its warps) or the ``__launch_bounds__`` minimum of blocks per
SM replaced, built by ``nvcc`` with the flags of ``ops/_build.py`` into a
temporary directory (all builds in parallel) and loaded with ``ctypes``.  At
each shape, every configuration's dq and dk/dv are held to the plain versions
(the largest abs error is printed) and timed: torch.profiler device time per
call over 50 calls.  Prints the card and ``ptxas``'s registers and spills of
each configuration's hd-48 kernels.  Needs an sm_90 card.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from ddl25spring_tpu_torch.ops import _build, flash_attention as fa  # noqa: E402

SOURCE = _build.CSRC / "flash_attention_tf32x3.cu"
# label -> replacements in the source; the first is the source as it stands
CONFIGS = {
    "OWN 32, 8 warps (the source)": {},
    "OWN 64, 8 warps": {"constexpr int OWN = 32;": "constexpr int OWN = 64;"},
    "OWN 16, 8 warps": {"constexpr int OWN = 32;": "constexpr int OWN = 16;"},
    "OWN 32, 16 warps": {"constexpr int NW = 8;": "constexpr int NW = 16;"},
    "OWN 32, 8 warps, 2 blocks/SM": {"__launch_bounds__(NT, 1)": "__launch_bounds__(NT, 2)"},
}
# (BH, Lq, Lk, hd, causal): the LLaMA path's and phase 7 (a)'s, non-causal,
# a long sequence; timed only at L >= 256 (the others are checked)
SHAPES = [(18, 256, 256, 48, True), (18, 256, 256, 48, False), (6, 256, 256, 48, True),
          (18, 1024, 1024, 64, True), (2, 100, 100, 112, True), (3, 17, 40, 36, False)]


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def build(tmp: str) -> dict:
    """Every configuration's library, built in parallel; a failed build is
    printed and left out."""
    src = SOURCE.read_text()
    procs = []
    for i, (label, subs) in enumerate(CONFIGS.items()):
        text = src
        for old, new in subs.items():
            if old not in text:
                raise RuntimeError(f"{label}: {old!r} is not in {SOURCE.name}")
            text = text.replace(old, new)
        cu = Path(tmp, f"config{i}.cu")
        cu.write_text(text)
        lib = cu.with_suffix(".so")
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib), str(cu)]
        procs.append((label, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True)))
    libs = {}
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [i32, i32, i32, i32, f32, i32, i32, ptr]  # bh Lq Lk hd scale causal dev stream
    for label, lib, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            print(f"{label}: nvcc exit {proc.returncode}\n{out[-3000:]}")
            continue
        usage, name = [], None
        for line in out.splitlines():
            if "Compiling entry function" in line:
                name = "dq" if "flash_dq" in line else "dkv"
                name += "<48>" if "ILi48E" in line else ""
            elif name and name.endswith("<48>") and ("registers" in line or "spill" in line):
                usage.append(f"{name} {line.split(':', 1)[-1].strip()}")
        print(f"{label}: " + "; ".join(usage))
        so = ctypes.CDLL(str(lib))
        so.ddl_flash_dq_tf32x3.argtypes = [ptr] * 7 + tail
        so.ddl_flash_dkv_tf32x3.argtypes = [ptr] * 8 + tail
        libs[label] = so
    return libs


def device_ms(fn, iters=50) -> float:
    """Self device time of every kernel ``fn`` launched, per call."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    n = sum(e.count for e in events)
    if n == 0 or n % iters:
        raise RuntimeError(f"the profiler recorded {n} kernels for {iters} calls")
    return sum(e.self_device_time_total for e in events) / 1e3 / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("tf32x3_configs: torch sees no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card())
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator().manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        for BH, Lq, Lk, hd, causal in SHAPES:
            q, do = (torch.randn(BH, Lq, hd, generator=gen).to(dev) for _ in range(2))
            k, v = (torch.randn(BH, Lk, hd, generator=gen).to(dev) for _ in range(2))
            o, lse = fa.flash_fwd_reference(q, k, v, causal)
            delta = (do * o).sum(-1)
            refs = fa.flash_bwd_reference(q, k, v, lse, do, delta, causal)
            dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
            ins = [x.data_ptr() for x in (q, k, v, do, lse, delta)]
            dims = (BH, Lq, Lk, hd, hd ** -0.5, int(causal), dev.index, stream)
            print(f"[{BH}, {Lq}, {Lk}, {hd}] {'causal' if causal else 'non-causal'}:")
            for label, so in libs.items():
                def run_dq(so=so):
                    code = so.ddl_flash_dq_tf32x3(*ins, dq.data_ptr(), *dims)
                    if code:
                        raise RuntimeError(f"{label}: dq launch failed ({code})")

                def run_dkv(so=so):
                    code = so.ddl_flash_dkv_tf32x3(*ins, dk.data_ptr(), dv.data_ptr(), *dims)
                    if code:
                        raise RuntimeError(f"{label}: dk/dv launch failed ({code})")

                try:
                    run_dq()
                    run_dkv()
                except RuntimeError as e:
                    print(f"  {label}: {e}")
                    continue
                torch.cuda.synchronize()
                err = max((a - r).abs().max().item() for a, r in zip((dq, dk, dv), refs))
                line = f"  {label}: max abs err {err:.2e}"
                if Lq >= 256:
                    t_dq, t_dkv = device_ms(run_dq), device_ms(run_dkv)
                    line += f"; dq {t_dq:.5f} ms, dk/dv {t_dkv:.5f} ms, pair {t_dq + t_dkv:.5f}"
                print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
