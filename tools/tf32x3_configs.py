"""Time the fp32 flash kernels (``ops/csrc/flash_attention_tf32x3.cu``) under
other block shapes than the ones the source fixes, on the card.

    python tools/tf32x3_configs.py            # the forward and the backward
    python tools/tf32x3_configs.py fwd        # the forward's configurations only
    python tools/tf32x3_configs.py bwd        # dq's and dk/dv's only

Run from the repository root.  Each configuration is a copy of the source
with the backward's ``OWN`` (the rows a block owns), ``NW`` (its warps) or
``__launch_bounds__`` minimum of blocks per SM replaced, or the forward's
(``FOWN``, ``FNW``), built by ``nvcc`` with the flags of ``ops/_build.py``
into a temporary directory (all builds in parallel) and loaded with
``ctypes``.  At each shape, every configuration's kernels of its kind are
held to the plain versions (the largest abs error is printed) and timed:
torch.profiler device time per call over 50 calls.  Prints the card and
``ptxas``'s registers and spills of each configuration's hd-48 kernels.
Needs an sm_90 card.
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
# kind -> label -> replacements in the source; the first of each kind is the
# source as it stands
CONFIGS = {
    "bwd": {
        "OWN 32, 8 warps (the source)": {},
        "OWN 64, 8 warps": {"constexpr int OWN = 32;": "constexpr int OWN = 64;"},
        "OWN 16, 8 warps": {"constexpr int OWN = 32;": "constexpr int OWN = 16;"},
        "OWN 32, 16 warps": {"constexpr int NW = 8;": "constexpr int NW = 16;"},
        "OWN 32, 8 warps, 2 blocks/SM": {"__launch_bounds__(NT, 1)": "__launch_bounds__(NT, 2)"},
    },
    # the forward: 32 rows of 8 warps (each a quarter of every walked tile,
    # merged at the end) against 64 rows of 4 warps (each the whole tile,
    # nothing to merge) and the shapes between
    "fwd": {
        "FOWN 32, 8 warps (the source)": {},
        "FOWN 64, 4 warps": {"constexpr int FOWN = 32;": "constexpr int FOWN = 64;",
                             "constexpr int FNW = 8;": "constexpr int FNW = 4;"},
        "FOWN 64, 8 warps": {"constexpr int FOWN = 32;": "constexpr int FOWN = 64;"},
        "FOWN 32, 4 warps": {"constexpr int FNW = 8;": "constexpr int FNW = 4;"},
        "FOWN 16, 4 warps": {"constexpr int FOWN = 32;": "constexpr int FOWN = 16;",
                             "constexpr int FNW = 8;": "constexpr int FNW = 4;"},
        "FOWN 16, 8 warps": {"constexpr int FOWN = 32;": "constexpr int FOWN = 16;"},
        "FOWN 32, 8 warps, 2 blocks/SM": {"__launch_bounds__(FNT, 1)":
                                          "__launch_bounds__(FNT, 2)"},
    },
}
# (BH, Lq, Lk, hd, causal): the LLaMA path's and phase 7 (a)'s, non-causal,
# a long sequence; timed only at L >= 256 (the others are checked)
SHAPES = [(18, 256, 256, 48, True), (18, 256, 256, 48, False), (6, 256, 256, 48, True),
          (18, 1024, 1024, 64, True), (2, 100, 100, 112, True), (3, 17, 40, 36, False)]


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def build(tmp: str, kinds) -> dict:
    """Every configuration's library of the given kinds, built in parallel,
    as ``{label: (kind, library)}``; a failed build is printed and left
    out."""
    src = SOURCE.read_text()
    procs = []
    todo = [(kind, label, subs) for kind in kinds for label, subs in CONFIGS[kind].items()]
    for i, (kind, label, subs) in enumerate(todo):
        text = src
        for old, new in subs.items():
            if old not in text:
                raise RuntimeError(f"{label}: {old!r} is not in {SOURCE.name}")
            text = text.replace(old, new)
        cu = Path(tmp, f"config{i}.cu")
        cu.write_text(text)
        lib = cu.with_suffix(".so")
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib), str(cu)]
        procs.append((kind, label, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                         stderr=subprocess.STDOUT, text=True)))
    libs = {}
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [i32, i32, i32, i32, f32, i32, i32, ptr]  # bh Lq Lk hd scale causal dev stream
    for kind, label, lib, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            print(f"{label}: nvcc exit {proc.returncode}\n{out[-3000:]}")
            continue
        usage, name, mine = [], None, False
        for line in out.splitlines():
            if "Compiling entry function" in line:
                name = next(n for n in ("fwd", "dq", "dkv") if f"flash_{n}_" in line)
                mine = (name == "fwd") == (kind == "fwd") and "ILi48E" in line
            elif mine and ("registers" in line or "spill" in line):
                usage.append(f"{name}<48> {line.split(':', 1)[-1].strip()}")
        print(f"{label}: " + "; ".join(usage))
        so = ctypes.CDLL(str(lib))
        so.ddl_flash_fwd_tf32x3.argtypes = [ptr] * 5 + tail
        so.ddl_flash_dq_tf32x3.argtypes = [ptr] * 7 + tail
        so.ddl_flash_dkv_tf32x3.argtypes = [ptr] * 8 + tail
        libs[label] = (kind, so)
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


def main(argv) -> int:
    kinds = argv or ["fwd", "bwd"]
    if not set(kinds) <= set(CONFIGS):
        print(f"tf32x3_configs: kinds are {sorted(CONFIGS)}, got {kinds}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("tf32x3_configs: torch sees no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card())
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator().manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp, kinds)
        for BH, Lq, Lk, hd, causal in SHAPES:
            q, do = (torch.randn(BH, Lq, hd, generator=gen).to(dev) for _ in range(2))
            k, v = (torch.randn(BH, Lk, hd, generator=gen).to(dev) for _ in range(2))
            o, lse = fa.flash_fwd_reference(q, k, v, causal)
            delta = (do * o).sum(-1)
            refs = fa.flash_bwd_reference(q, k, v, lse, do, delta, causal)
            dq, dk, dv, o_k = (torch.empty_like(x) for x in (q, k, v, q))
            lse_k = torch.empty_like(lse)
            ins = [x.data_ptr() for x in (q, k, v, do, lse, delta)]
            dims = (BH, Lq, Lk, hd, hd ** -0.5, int(causal), dev.index, stream)
            print(f"[{BH}, {Lq}, {Lk}, {hd}] {'causal' if causal else 'non-causal'}:")
            if Lq >= 256 and "fwd" in kinds:
                sdpa = torch.nn.functional.scaled_dot_product_attention
                t = device_ms(lambda: sdpa(q[None], k[None], v[None], is_causal=causal))
                print(f"  SDPA fp32 forward (the yardstick): {t:.5f} ms")
            for label, (kind, so) in libs.items():
                def run_fwd(so=so):
                    code = so.ddl_flash_fwd_tf32x3(*ins[:3], o_k.data_ptr(), lse_k.data_ptr(),
                                                   *dims)
                    if code:
                        raise RuntimeError(f"{label}: forward launch failed ({code})")

                def run_dq(so=so):
                    code = so.ddl_flash_dq_tf32x3(*ins, dq.data_ptr(), *dims)
                    if code:
                        raise RuntimeError(f"{label}: dq launch failed ({code})")

                def run_dkv(so=so):
                    code = so.ddl_flash_dkv_tf32x3(*ins, dk.data_ptr(), dv.data_ptr(), *dims)
                    if code:
                        raise RuntimeError(f"{label}: dk/dv launch failed ({code})")

                try:
                    if kind == "fwd":
                        run_fwd()
                    else:
                        run_dq()
                        run_dkv()
                except RuntimeError as e:
                    print(f"  {label}: {e}")
                    continue
                torch.cuda.synchronize()
                got = (o_k, lse_k) if kind == "fwd" else (dq, dk, dv)
                want = (o, lse) if kind == "fwd" else refs
                err = max((a - r).abs().max().item() for a, r in zip(got, want))
                line = f"  {label}: max abs err {err:.2e}"
                if Lq >= 256 and kind == "fwd":
                    line += f"; forward {device_ms(run_fwd):.5f} ms"
                elif Lq >= 256:
                    t_dq, t_dkv = device_ms(run_dq), device_ms(run_dkv)
                    line += f"; dq {t_dq:.5f} ms, dk/dv {t_dkv:.5f} ms, pair {t_dq + t_dkv:.5f}"
                print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
