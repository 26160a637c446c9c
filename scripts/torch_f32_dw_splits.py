"""Device ms of the float32 instances of kernels 12 and 16 (the fused
1x1-conv and 3x3-conv + BN weight gradients, the 3xTF32 tiles) at every
shape a ResNet-50 v1 training step at B=128 gives them (chip_smoke.py
phase 7: 36 launches of kernel 12 over 16 shapes, 16 of kernel 16 over
4), under several rules for the runs of M (pixels) over which each tile
writes its float32 partials: the bfloat16 tiles' rules and the
candidates for the float32 ones.  CUDA-event time over 20 calls after 3
warm-up calls, one input set a shape; prints each shape's time under
each rule with its runs, and each rule's sum over a step's launches.
Run from the root of a checkout on one CUDA card:

    python3 scripts/torch_f32_dw_splits.py
"""
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from incubator_mxnet_tpu_torch.ops import _fused_common as common  # noqa
from incubator_mxnet_tpu_torch.ops import fused_block as fb  # noqa: E402
from incubator_mxnet_tpu_torch.ops import fused_conv as fc  # noqa: E402


def fmm_rule(blocks_per_sm, factor):
    """Runs for about ``blocks_per_sm`` blocks an SM, no partial above
    ``2 / factor`` of the bytes a run of float32 rows reads."""
    def split(m, k, n, sms):
        return fb._dw_runs(m, k, n, sms, blocks_per_sm,
                           factor * k * n // (k + 2 * n))
    return split


def conv_rule(blocks_per_sm, pixels):
    """Runs for about ``blocks_per_sm`` blocks an SM, of at least
    ``pixels`` pixels."""
    def split(n, h, w, c, co, sms):
        return fc._dw_runs(n, h, w, c, co, sms, blocks_per_sm, pixels)
    return split


# kernel 12: (blocks an SM, the partial's largest share of a run's
# reads); kernel 16: (blocks an SM, the least pixels a run)
FMM_RULES = {"bf16 rule (4, 1/8 of 2-byte rows)": fmm_rule(4, 32),
             "(3, 1/8)": fmm_rule(3, 16), "(6, 1/8)": fmm_rule(6, 16),
             "dw_tf32_split (6, 1/4)": fb.dw_tf32_split,
             "(12, 1/4)": fmm_rule(12, 8)}
CONV_RULES = {"bf16 rule (2, 2048)": conv_rule(2, 2048),
              "(2, 1024)": conv_rule(2, 1024), "(4, 1024)": conv_rule(4, 1024),
              "(6, 512)": conv_rule(6, 512),
              "dw_tf32_split (waves x run, 1024)": fc.dw_tf32_split}


def event_ms(fn, args, iters=20, warmup=3):
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn(*args)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def sweep(module, rules, calls, shape_args, wrapper, dims):
    """Each shape's time under each rule, and each rule's step total;
    ``dims(shape)`` are the split rule's arguments before ``sms``."""
    sms = common.sms(0)
    total = dict.fromkeys(rules, 0.0)
    kept = module.dw_tf32_split
    try:
        for shape in dict.fromkeys(calls):
            args = shape_args(shape)
            line = f"{shape} x{calls.count(shape)}:"
            for name, rule in rules.items():
                module.dw_tf32_split = rule
                ms = event_ms(wrapper, args)
                total[name] += ms * calls.count(shape)
                runs = module.dw_tf32_split(*dims(shape), sms)
                line += f" [{name}: {ms:.4f} ms, runs {runs}]"
            print(line, flush=True)
            del args
    finally:
        module.dw_tf32_split = kept
    for name, ms in total.items():
        print(f"  {name}: {ms:.3f} ms a step", flush=True)


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi(), flush=True)

    def fmm_args(shape):
        m, k, n, pro = shape
        x, w, scale, bias, dy, ds1, ds2 = cs.fmm_inputs(
            torch, m, k, n, "float32", dev, 0)
        if not pro:
            scale = bias = None
        y = fb.matmul_bn_reference(x, w, scale, bias)[0]
        return x, w, scale, bias, y, dy, ds1, ds2

    def conv_args(shape):
        x, k, scale, bias, dy, ds1, ds2 = cs.conv_inputs(
            torch, shape, "float32", dev, 0)
        y = fc.conv3_bn_reference(x, k, scale, bias)[0]
        return x, k, scale, bias, y, dy, ds1, ds2

    print("kernel 12, float32 (M, K, N, prologue):", flush=True)
    sweep(fb, FMM_RULES, cs.resnet_fmm_shapes(cs.RESNET_B),
          fmm_args, fb.fused_matmul_bn_dw, lambda shape: shape[:3])
    print("kernel 16, float32 (N, H, W, C, C_out), prologue:", flush=True)
    sweep(fc, CONV_RULES, cs.resnet_conv3_shapes(cs.RESNET_B),
          conv_args, fc.fused_conv3_bn_dw, lambda shape: shape)


if __name__ == "__main__":
    main()
