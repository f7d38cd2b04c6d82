"""What the MoE dispatch costs beside the expert products: the committed
``repro_torch.models.modules.moe_apply`` against its first design, timed
on the card at qwen3-moe-30b-a3b's width (128 experts of d_ff 768, top 8,
capacity factor 1.25, D 2048, bf16, one layer of random weights) for the
routing groups the engines form: a packed prefill launch (1, 2048), a
decode step (8, 1), a verify window (8, 5) and a static prefill pass
(8, 1024).

    python3 tools/moe_dispatch_variants.py

Prints, per variant and shape, the device time of one call (the kernels
torch.profiler records over 24 calls, summed), the time of its three
expert products alone on the same buffer, and the variants' largest
difference.  The variants:
  committed  a gather dispatch (each buffer row names its token, or a zero
             row) and one ``matmul`` combine over the k weights
  scatter    the first design: the token rows expanded k times and written
             into a zeroed expert-major buffer by ``index_copy_``, the
             outputs gathered at the clamped rank, dropped slots zeroed by
             ``where``, and an elementwise float32 combine
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import modules as mod  # noqa: E402

SHAPES = {"packed launch": (1, 2048), "decode step": (8, 1), "verify window": (8, 5),
          "static pass": (8, 1024)}
CALLS = 24


def scatter_apply(p, x, cfg):
    """The first design of ``moe_apply`` (same routing and semantics)."""
    b, s, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    C = mod.moe_capacity(cfg, s)
    _, weights, idx = mod.moe_route(p, x, cfg)
    eid = idx.reshape(b, s * K)
    pos = mod._positions_in_expert(eid, E)
    valid = pos < C
    rows = torch.arange(b, device=x.device)[:, None]
    slot = (eid * b + rows) * C + pos.clamp_max(C - 1)
    buf = x.new_zeros((E * b * C + 1, D))
    buf.index_copy_(0, torch.where(valid, slot, E * b * C).reshape(-1),
                    x[:, :, None, :].expand(b, s, K, D).reshape(b * s * K, D))
    h = buf[:-1].view(E, b * C, D)
    out_buf = torch.bmm(F.silu(torch.bmm(h, p["w_gate"])) * torch.bmm(h, p["w_up"]),
                        p["w_down"]).view(E * b * C, D)
    gathered = torch.where(valid.reshape(b, s, K, 1),
                           out_buf[slot.reshape(-1)].view(b, s, K, D), 0)
    w = weights.to(x.dtype).float()[..., None]
    return (gathered.float() * w).sum(2).to(x.dtype)


def experts_only(p, h):
    """The three expert products on an expert-major buffer h (E, rows, D)."""
    return torch.bmm(F.silu(torch.bmm(h, p["w_gate"])) * torch.bmm(h, p["w_up"]), p["w_down"])


def device_ms(fn):
    """Device ms of one ``fn()``: the durations of the kernels, copies and
    sets torch.profiler records over CALLS calls, summed, over CALLS.  (A
    call launches ~35 kernels, so CALLS of them overflow the launch queue
    behind a sleep kernel: events around them would time the host.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    ns = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA)
    if ns <= 0:
        raise SystemExit("the profiler recorded no device time")
    return ns / 1e6 / CALLS


def main():
    if not torch.cuda.is_available():
        print("moe_dispatch_variants: no CUDA device", file=sys.stderr)
        return 1
    import subprocess

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda")
    cfg = get_config("qwen3-moe-30b-a3b")
    E, D, Fd = cfg.num_experts, cfg.d_model, cfg.d_ff
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev, dtype=torch.bfloat16)
    p = {"router": randn(D, E) * 0.02, "w_gate": randn(E, D, Fd) * 0.02,
         "w_up": randn(E, D, Fd) * 0.02, "w_down": randn(E, Fd, D) * 0.02}
    with torch.no_grad():
        for label, (rows, s) in SHAPES.items():
            x = randn(rows, s, D)
            C = mod.moe_capacity(cfg, s)
            h = randn(E, rows * C, D)
            got = mod.moe_apply(p, x, cfg, need_aux=False)[0]
            first = scatter_apply(p, x, cfg)
            t = {"committed": device_ms(lambda: mod.moe_apply(p, x, cfg, need_aux=False)),
                 "scatter": device_ms(lambda: scatter_apply(p, x, cfg)),
                 "experts": device_ms(lambda: experts_only(p, h))}
            print(f"{label} x ({rows}, {s}, {D}), C {C}: committed {t['committed']:.4f} ms, "
                  f"scatter {t['scatter']:.4f} ms, the expert products alone "
                  f"{t['experts']:.4f} ms; dispatch committed "
                  f"{t['committed'] - t['experts']:.4f} ms, scatter "
                  f"{t['scatter'] - t['experts']:.4f} ms; max |committed - scatter| "
                  f"{float((got.float() - first.float()).abs().max()):.3e}, equal bits "
                  f"{torch.equal(got, first)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
