"""The port's ``rtc`` against the JAX package's (``tests/test_rtc.py``).

``PallasModule`` kernels run in the port over tensors and in the JAX
package in Pallas interpret mode, on the same numpy inputs; outputs
agree to 1e-6 (the same float32 arithmetic).  ``CudaModule`` compiles
CUDA C only for a card: here it raises ``DeviceUnavailableError``.  Its
signature parser and argument checks run without a card.
"""
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu_torch import context, rtc
from incubator_mxnet_tpu_torch.error import DeviceUnavailableError

TOL = dict(rtol=1e-6, atol=1e-6)


def _inputs(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def test_saxpy_matches_jax():
    def saxpy(x_ref, y_ref, o_ref, *, alpha):
        o_ref[...] = x_ref[...] * alpha + y_ref[...]

    x, y = _inputs((8, 128), (8, 128))
    want = mx.rtc.PallasModule(saxpy, num_inputs=2, static_args=("alpha",)
                               ).get_kernel("saxpy", alpha=3.0).launch(
        [nd.array(x), nd.array(y)], mx.tpu(0)).asnumpy()
    got = rtc.PallasModule(saxpy, num_inputs=2, static_args=("alpha",)
                           ).get_kernel("saxpy", alpha=3.0).launch(
        [torch.from_numpy(x), torch.from_numpy(y)], context.cpu())
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    ones = rtc.PallasModule(saxpy, num_inputs=2, static_args=("alpha",)
                            ).get_kernel("saxpy", alpha=3.0).launch(
        [torch.ones(8, 128), torch.ones(8, 128)])
    np.testing.assert_allclose(ones.numpy(), 4.0 * np.ones((8, 128)), **TOL)


def test_inplace_output_arg_matches_jax():
    def double(x_ref, o_ref):
        o_ref[...] = x_ref[...] * 2.0

    (x,) = _inputs((4, 128), seed=1)
    target = nd.zeros((4, 128))
    ret = mx.rtc.PallasModule(double, num_inputs=1).get_kernel(
        "double").launch([nd.array(x), target], mx.tpu(0))
    assert ret is target
    out = torch.zeros(4, 128)
    got = rtc.PallasModule(double, num_inputs=1).get_kernel("double").launch(
        [torch.from_numpy(x), out])
    assert got is out
    np.testing.assert_allclose(out.numpy(), target.asnumpy(), **TOL)
    with pytest.raises(ValueError, match="shape"):
        rtc.PallasModule(double).get_kernel("double").launch(
            [torch.from_numpy(x), torch.zeros(2, 128)])


def test_cuda_source_refused_where_there_is_no_card(monkeypatch):
    with pytest.raises(TypeError, match="Pallas"):
        mx.rtc.CudaModule("__global__ void axpy(float*x){}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError, match="CPU"):
        rtc.CudaModule("__global__ void axpy(float*x){}")
    with pytest.raises(TypeError, match="CudaModule"):
        rtc.PallasModule("__global__ void axpy(float*x){}")


def test_unknown_kernel_and_static_args_as_in_jax():
    def k(x_ref, o_ref):
        o_ref[...] = x_ref[...]

    for mod in (mx.rtc.PallasModule(k), rtc.PallasModule(k),
                rtc.CudaModule(k)):
        with pytest.raises(ValueError, match="no kernel"):
            mod.get_kernel("nope")
        with pytest.raises(ValueError, match="unknown static"):
            mod.get_kernel("k", beta=1.0)


def test_cuda_module_of_a_python_kernel_is_a_pallas_module():
    def neg(x_ref, o_ref):
        o_ref[...] = -x_ref[...]

    (x,) = _inputs((3, 5), seed=2)
    want = mx.rtc.CudaModule(neg).get_kernel("neg").launch(
        [nd.array(x)]).asnumpy()
    mod = rtc.CudaModule(neg)
    assert isinstance(mod, rtc.PallasModule)
    got = mod.get_kernel("neg").launch([torch.from_numpy(x)])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("grid", [(4,), (2, 3)])
def test_grid_kernel_with_program_id_matches_jax(grid):
    """One call per grid point in row-major order, each writing its own
    rows: ``rtc.program_id``/``num_programs`` in the port,
    ``pl.program_id``/``pl.num_programs`` in JAX."""
    rows = 4 * int(np.prod(grid))

    def make(program_id, num_programs, ds):
        def kern(x_ref, y_ref, o_ref, *, alpha):
            flat = program_id(0)
            total = num_programs(0)
            if len(grid) == 2:
                flat = flat * num_programs(1) + program_id(1)
                total = total * num_programs(1)
            sl = ds(flat * 4, 4)
            o_ref[sl, :] = x_ref[sl, :] * alpha + y_ref[sl, :] * total
        return kern

    x, y = _inputs((rows, 128), (rows, 128), seed=3)
    want = mx.rtc.PallasModule(
        make(pl.program_id, pl.num_programs, pl.ds), num_inputs=2,
        static_args=("alpha",)).get_kernel("kern", alpha=0.5).launch(
        [nd.array(x), nd.array(y)], grid_dims=grid).asnumpy()
    port = make(rtc.program_id, rtc.num_programs,
                lambda start, n: slice(start, start + n))
    got = rtc.PallasModule(port, num_inputs=2, static_args=("alpha",),
                           grid=grid).get_kernel("kern", alpha=0.5).launch(
        [torch.from_numpy(x), torch.from_numpy(y)])
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    with pytest.raises(RuntimeError, match="inside"):
        rtc.program_id(0)


def test_out_like_sets_the_output_shape_and_dtype():
    def first_row(x_ref, o_ref):
        o_ref[...] = x_ref[0, :].to(o_ref.dtype)

    like = torch.zeros(7, dtype=torch.float64)
    out = rtc.PallasModule(first_row, out_like=like).get_kernel(
        "first_row").launch(
        [torch.arange(14.0).reshape(2, 7)])
    assert out.dtype == torch.float64 and out.shape == (7,)
    np.testing.assert_array_equal(out.numpy(), np.arange(7.0))


@pytest.mark.parametrize("ctype,dtype", [
    ("float", torch.float32), ("double", torch.float64),
    ("__half", torch.float16), ("uint8_t", torch.uint8),
    ("int", torch.int32), ("int32_t", torch.int32), ("int8_t", torch.int8),
    ("char", torch.int8), ("int64_t", torch.int64)])
def test_signature_parser_takes_every_base_type(ctype, dtype):
    sig = f"const {ctype} *x, {ctype}* y, {ctype} s, const {ctype} c"
    assert rtc.parse_signature(sig) == [
        ("x", ctype, True, True), ("y", ctype, True, False),
        ("s", ctype, False, False), ("c", ctype, False, True)]
    assert rtc._TYPES[ctype][1] == dtype
    assert rtc.parse_signature(f"  {ctype}   *  ") == [
        ("arg0", ctype, True, False)]


@pytest.mark.parametrize("sig,what", [
    ("float x y", "form"), ("vec3 *x", "unknown type 'vec3'"),
    ("const", "form"), ("", "form"), ("float **x", "form"),
    ("float *x,", "form"), ("float x[4]", "form"),
    ("unsigned int n", "form"), ("size_t n", "unknown type 'size_t'")])
def test_signature_parser_refuses_malformed_parameters(sig, what):
    with pytest.raises(ValueError, match=what):
        rtc.parse_signature(sig)


def test_cuda_kernel_checks_arguments_before_any_launch():
    """The checks a launch makes before it touches the driver, on a
    kernel bound to a signature without compiling (no card here)."""
    k = rtc.CudaKernel(None, "saxpy", "saxpy", rtc.parse_signature(
        "const float *x, float *y, float a, int n"))
    dev = torch.device("cpu")
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="4 arguments, got 3"):
        k._pack([x, x, 1.0], dev)
    with pytest.raises(TypeError, match="wants a tensor"):
        k._pack([1.0, x, 1.0, 4], dev)
    with pytest.raises(TypeError, match="float64"):
        k._pack([x.double(), x, 1.0, 4], dev)
    with pytest.raises(ValueError, match="contiguous"):
        k._pack([torch.zeros(8)[::2], x, 1.0, 4], dev)
    with pytest.raises(ValueError, match="on cpu"):
        k._pack([x, x, 1.0, 4], torch.device("meta"))
    with pytest.raises(TypeError, match="wants a number"):
        k._pack([x, x, x, 4], dev)
    values = k._pack([x, x, 1.5, 4], dev)
    assert [v.dtype for v in values] == [np.uint64, np.uint64, np.float32,
                                        np.int32]
    assert values[0] == x.data_ptr() and values[2] == 1.5
    half = rtc.CudaKernel(None, "h", "h", rtc.parse_signature("__half a"))
    (bits,) = half._pack([1.5], dev)
    assert bits.dtype == np.float16 and bits.tobytes() == np.float16(
        1.5).tobytes()
    with pytest.raises(ValueError, match="CUDA"):
        k.launch([x, x, 1.0, 4], context.cpu(), 1, 1)
    with pytest.raises(ValueError, match="grid_dims"):
        rtc._dims((1, 2, 3, 4), "grid_dims")
    assert rtc._dims(5, "grid_dims") == (5, 1, 1)
    assert rtc._dims((2, 3), "block_dims") == (2, 3, 1)
