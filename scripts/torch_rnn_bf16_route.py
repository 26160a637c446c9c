"""Which route PyTorch's RNN op takes for a bfloat16 input on the card,
and what each route costs: ``torch._VF.lstm`` and ``torch._VF.gru`` at
the LSTM LM's shape (T=35, B=32, 650 inputs and units, 2 layers) on
bfloat16 CUDA tensors, once with cuDNN on (the default) and once off
(``torch.backends.cudnn.flags(enabled=False)``: PyTorch's own loop of
cell kernels).  For each: whether it runs, the device kernels of one
forward + backward by the profiler's names, the output's and weight
gradient's distance from the same call in float32 with cuDNN off on the
same bf16-rounded inputs, and the forward + backward time (host clock
around 10 calls ending in a synchronise, after 3).  Prints
``torch.backends.cudnn.is_acceptable`` of a bfloat16 tensor beside it,
and the card's name and power limit first.  TF32 is off.  Needs one
CUDA card:

    python3 scripts/torch_rnn_bf16_route.py
"""
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

T, B, I, H, L = 35, 32, 650, 650, 2


def weights(ng, dtype, dev):
    g = torch.Generator().manual_seed(0)
    ws = []
    for layer in range(L):
        i = I if layer == 0 else H
        ws += [torch.randn(ng * H, i, generator=g) * 0.05,
               torch.randn(ng * H, H, generator=g) * 0.05,
               torch.randn(ng * H, generator=g) * 0.05,
               torch.randn(ng * H, generator=g) * 0.05]
    return [w.to(dev, dtype).requires_grad_() for w in ws]


def run(mode, x, hx, ws):
    out = getattr(torch._VF, mode)(x, hx, ws, True, L, 0.0, True, False,
                                   False)
    out[0].float().sum().backward()
    return out[0]


def main():
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    bf16 = torch.bfloat16
    print("cudnn.is_acceptable(bfloat16 tensor):",
          torch.backends.cudnn.is_acceptable(torch.empty(1, device=dev,
                                                         dtype=bf16)),
          flush=True)
    for mode, ng in (("lstm", 4), ("gru", 3)):
        x = torch.randn(T, B, I, generator=torch.Generator().manual_seed(1))
        x = x.to(dev, bf16).requires_grad_()
        h0 = torch.zeros(L, B, H, device=dev, dtype=bf16)
        hx = (h0, h0.clone()) if mode == "lstm" else h0
        for cudnn_on in (True, False):
            ws = weights(ng, bf16, dev)
            with torch.backends.cudnn.flags(enabled=cudnn_on):
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    out = run(mode, x, hx, ws)
                    torch.cuda.synchronize()
                names = sorted({e.name[:90] for e in prof.events()
                                if e.device_type.name == "CUDA"})
                x32 = x.detach().float().requires_grad_()
                ws32 = [w.detach().float().requires_grad_() for w in ws]
                hx32 = (tuple(h.float() for h in hx) if mode == "lstm"
                        else hx.float())
                with torch.backends.cudnn.flags(enabled=False):
                    out32 = run(mode, x32, hx32, ws32)
                d_out = (out.float() - out32).abs().max().item()
                d_w = ((ws[0].grad.float() - ws32[0].grad).abs().max()
                       / ws32[0].grad.abs().max()).item()
                for _ in range(3):
                    run(mode, x, hx, ws)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(10):
                    run(mode, x, hx, ws)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) / 10 * 1e3
            print(f"{mode} bfloat16, cudnn enabled={cudnn_on}: out "
                  f"{out.dtype}, max|out - float32| {d_out:.3e}, layer-0 "
                  f"w_ih gradient max|d|/max|float32| {d_w:.3e}; forward + "
                  f"backward {ms:.3f} ms", flush=True)
            print(f"  kernels: {names}", flush=True)


if __name__ == "__main__":
    main()
