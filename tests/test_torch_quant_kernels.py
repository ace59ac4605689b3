"""The port's int8 kernels' plain versions and the fused bias+act against
the JAX package, on the CPU.

Inputs are made with numpy from seeds and given to both packages. Where
the JAX function reaches its Pallas kernel it runs as the JAX package's own
tests run it here: ``interpret=True`` (the real integer kernel body), or
its XLA reference. Tolerances:

- activation and weight quantization: bitwise (q and scale);
- integer accumulators: equal (run with unit scales, so the output is the
  accumulator);
- int8 matmul/conv outputs against the interpreted kernel and against
  ``int8_matmul_xla``: within 1 ulp of the output dtype (the same integer
  sums and the same epilogue ops), except float32 output against the
  interpreted kernel, whose XLA contracts ``acc * s + b`` into an FMA: there
  1 ulp of the output plus 1 ulp of the product;
- int8 conv against ``int8_conv2d_reference`` (dequantize, then an f32
  conv, whose sums round): 2e-2 · max|out| + 1 bf16 ulp;
- fused bias+act: 1 ulp of the output dtype;
- wherever the act is sigmoid or gelu, 1e-6 absolute more (two libms, and
  gelu's tanh form written out differently), the fused BN+act tolerance.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as jnn

from tensorflowdistributedlearning_tpu.ops import pallas_kernels as jpk
from tensorflowdistributedlearning_tpu.ops import quant_kernels as jqk
from tensorflowdistributedlearning_tpu.train import quantize as jq
from tensorflowdistributedlearning_tpu_torch.config import ModelConfig
from tensorflowdistributedlearning_tpu_torch.models.resnet import ResNetSegmentation
from tensorflowdistributedlearning_tpu_torch.ops import kernels as tk
from tensorflowdistributedlearning_tpu_torch.ops import quant_kernels as qk
from tensorflowdistributedlearning_tpu_torch.train import quantize as tq
from tests.test_torch_dp_worker import one_torch_thread  # noqa: F401 (autouse)


ACTS = ["none", "relu", "relu6", "sigmoid", "gelu"]


@pytest.fixture(autouse=True)
def _zero_counts():
    tk.reset_launch_counts()
    yield
    assert sum(tk.launch_counts().values()) == 0  # CPU tensors launch nothing


def _ordered(a: np.ndarray, dtype) -> np.ndarray:
    """Monotone integer image of float values, one step per ulp of ``dtype``."""
    a = np.asarray(a, np.float32)
    bits = a.view(np.int32).astype(np.int64)
    if dtype == "bfloat16":
        bits = bits >> 16
        neg = np.int64(-(1 << 15))
    else:
        neg = np.int64(-(1 << 31))
    return np.where(bits < 0, neg - bits, bits)


def ulps(a, b, dtype) -> int:
    return int(np.abs(_ordered(a, dtype) - _ordered(b, dtype)).max())


def close(a, b, dtype, act) -> bool:
    """Within 1 ulp of ``dtype``; sigmoid and gelu (two libms, and gelu's
    tanh form written out differently) also get 1e-6 absolute, the fused BN+act
    tolerance."""
    if act not in ("sigmoid", "gelu"):
        return ulps(a, b, dtype) <= 1
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    step = np.spacing(np.abs(b)) * (2.0 ** 16 if dtype == "bfloat16" else 1.0)
    return bool((np.abs(a - b) <= step + 1e-6).all())


def _np(t) -> np.ndarray:
    if torch.is_tensor(t):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


# -- activation quantization ------------------------------------------------------


@pytest.mark.parametrize("scale", [1e-3, 1.0, 37.5, 1e4])
@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (64, 9)])
def test_quantize_activations_bitwise(shape, scale):
    x = (np.random.default_rng(int(scale * 10) + len(shape)).standard_normal(shape) * scale).astype(np.float32)
    jq_, js = jqk.quantize_activations(jnp.asarray(x))
    q, s = qk.quantize_activations(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.dim() == 0
    assert np.float32(s.item()).tobytes() == np.asarray(js, np.float32).tobytes()
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))


def test_quantize_activations_half_steps_round_to_even():
    # max|x| = 127 gives scale 1: the .5 values must round half to even
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5], np.float32)
    q, s = qk.quantize_activations(torch.from_numpy(x))
    assert s.item() == 1.0
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqk.quantize_activations(jnp.asarray(x))[0]))
    np.testing.assert_array_equal(q.numpy(), [127, 0, 2, 2, 0, -2, -2, 126])


def test_quantize_activations_all_zero_and_bf16():
    q, s = qk.quantize_activations(torch.zeros(3, 4, 4, 2))
    assert s.item() == 1.0 and int(q.abs().max()) == 0
    x = np.random.default_rng(1).standard_normal((4, 6, 6, 8)).astype(np.float32) * 3
    xb = jnp.asarray(x, jnp.bfloat16)
    jq_, js = jqk.quantize_activations(xb)
    q, s = qk.quantize_activations(torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16))
    assert s.item() == float(js)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))


def test_quantize_activations_padding_invariance():
    x = np.random.default_rng(2).standard_normal((3, 5, 5, 4)).astype(np.float32)
    padded = np.concatenate([x, np.zeros((13, 5, 5, 4), np.float32)])
    q, s = qk.quantize_activations(torch.from_numpy(x))
    qp, sp = qk.quantize_activations(torch.from_numpy(padded))
    assert s.item() == sp.item()
    assert torch.equal(qp[:3], q) and int(qp[3:].abs().max()) == 0


# -- per-channel weight quantization --------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 3, 5, 7), (1, 1, 16, 4), (5, 5, 3, 1)])
def test_weight_quantizer_matches_jax_on_conv_filters(shape):
    w = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32) * 0.2
    w[..., 0] = 0.0  # a zero output channel keeps scale 1
    want = jq._quantize_leaf_int8(w)
    rec = tq.quantize_leaf_int8(torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))), axis=0)
    assert rec["scale"].numpy().tobytes() == want["scale"].tobytes()
    assert rec["scale"][0].item() == 1.0
    np.testing.assert_array_equal(rec["q"].numpy(), want["q"].transpose(3, 2, 0, 1))
    assert rec["q"].dtype == torch.int8 and rec["q"].is_contiguous()


def test_weight_quantizer_matches_jax_on_depthwise_filters():
    w = np.random.default_rng(7).standard_normal((3, 3, 1, 24)).astype(np.float32)
    w[:, :, :, 5] = 0.0
    want = jq._quantize_leaf_int8(w)
    rec = tq.quantize_leaf_int8(torch.from_numpy(w[:, :, 0, :]), axis=-1)
    assert rec["scale"].numpy().tobytes() == want["scale"].tobytes()
    np.testing.assert_array_equal(rec["q"].numpy(), want["q"][:, :, 0, :])
    # dequantization in bf16, as dequantize_pytree
    got = tq.dequantize({"w": rec})["w"]
    want_deq = jq.dequantize_pytree({"w": {"__int8__": True, **want}})["w"]
    np.testing.assert_array_equal(got.float().numpy(), _np(want_deq)[:, :, 0, :])


# -- int8 matmul ----------------------------------------------------------------------


def _matmul_case(seed, m, k, n, unit=False):
    rng = np.random.default_rng(seed)
    if unit:
        x = rng.integers(-127, 128, (m, k)).astype(np.float32)
        x[0, 0] = 127.0  # max|x| = 127: activation scale exactly 1
        ws = np.ones(n, np.float32)
    else:
        x = rng.standard_normal((m, k)).astype(np.float32) * 2
        ws = rng.uniform(1e-3, 2e-2, n).astype(np.float32)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    bias = rng.standard_normal(n).astype(np.float32)
    return x, wq, ws, bias


@pytest.mark.parametrize("mkn", [(7, 33, 5), (64, 48, 16), (1, 300, 3)])
def test_int8_matmul_accumulator_is_xlas(mkn):
    x, wq, ws, _ = _matmul_case(sum(mkn), *mkn, unit=True)
    got = qk.int8_matmul_plain(torch.from_numpy(x), torch.from_numpy(wq), torch.from_numpy(ws),
                               out_dtype=torch.float32)
    want = jqk.int8_matmul_xla(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(ws), out_dtype=jnp.float32)
    exact = (x.astype(np.int64) @ wq.astype(np.int64)).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), exact)
    np.testing.assert_array_equal(np.asarray(want), exact)


@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("act", ACTS)
def test_int8_matmul_plain_matches_jax(act, out_dtype):
    x, wq, ws, bias = _matmul_case(11, 37, 70, 24)
    tdt, jdt = getattr(torch, out_dtype), getattr(jnp, out_dtype)
    got = qk.int8_matmul_plain(torch.from_numpy(x), torch.from_numpy(wq), torch.from_numpy(ws),
                               bias=torch.from_numpy(bias), act=act, out_dtype=tdt)
    assert got.dtype == tdt and got.shape == (37, 24)
    kwargs = dict(bias=jnp.asarray(bias), act=act, out_dtype=jdt)
    xla = jqk.int8_matmul_xla(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(ws), **kwargs)
    interp = jqk.int8_matmul(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(ws), interpret=True, **kwargs)
    assert close(_np(got), _np(xla), out_dtype, act)
    if out_dtype == "bfloat16":
        assert close(_np(got), _np(interp), out_dtype, act)
    else:
        # the interpreted kernel's XLA contracts acc*s + b into one FMA: the
        # port rounds the product on its own (as the CUDA kernel does), so
        # the two differ by up to the product's rounding, then the act's
        xq, xs = qk.quantize_activations(torch.from_numpy(x))
        prod = (xq.double() @ torch.from_numpy(wq).double()).float() * (xs * torch.from_numpy(ws))
        tol = np.spacing(np.abs(_np(got))) + np.spacing(np.abs(prod.numpy()))
        if act in ("sigmoid", "gelu"):
            tol = tol + 1e-6
        assert (np.abs(_np(got) - _np(interp)) <= tol).all()


def test_int8_matmul_keeps_leading_dims_and_no_bias():
    x, wq, ws, _ = _matmul_case(3, 2 * 3 * 5, 16, 8)
    x3 = x.reshape(2, 3, 5, 16)
    got = qk.int8_matmul(torch.from_numpy(x3), torch.from_numpy(wq), torch.from_numpy(ws))
    want = qk.int8_matmul_plain(torch.from_numpy(x), torch.from_numpy(wq), torch.from_numpy(ws))
    assert got.shape == (2, 3, 5, 8) and got.dtype == torch.float32
    assert torch.equal(got.reshape(30, 8), want)


# -- int8 conv2d ----------------------------------------------------------------------

CONV_CASES = [
    # (B, H, W, Cin, Cout, k, padding, bias)
    (2, 9, 7, 16, 8, 1, "SAME", True),
    (2, 9, 7, 5, 6, 3, "SAME", False),
    (1, 11, 13, 3, 4, 5, "SAME", True),
    (2, 8, 9, 6, 5, 3, "VALID", True),
    (1, 10, 7, 4, 3, 3, ((2, 0), (1, 3)), False),
    (3, 7, 7, 32, 1, 3, "SAME", True),
]


def _conv_case(case, seed):
    b, h, w, cin, cout, k, padding, with_bias = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32) * 1.5
    wq = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    ws = rng.uniform(1e-3, 1e-2, cout).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32) if with_bias else None
    return x, wq, ws, padding, bias


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: f"{c[5]}x{c[5]}-{c[6] if isinstance(c[6], str) else 'pads'}-"
                         f"cin{c[3]}-cout{c[4]}-{'bias' if c[7] else 'nobias'}")
def test_int8_conv2d_plain_matches_the_interpreted_kernel(case):
    x, wq, ws, padding, bias = _conv_case(case, sum(case[:5]))
    tb = None if bias is None else torch.from_numpy(bias)
    got = qk.int8_conv2d_plain(torch.from_numpy(x), torch.from_numpy(wq), torch.from_numpy(ws), padding=padding,
                               bias=tb, out_dtype=torch.bfloat16)
    jb = None if bias is None else jnp.asarray(bias)
    want = jqk.int8_conv2d(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(ws), padding=padding, bias=jb,
                           out_dtype=jnp.bfloat16, interpret=True)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert ulps(_np(got), _np(want), "bfloat16") <= 1
    # the dequantize-then-f32 oracle rounds its sums: a tolerance
    ref = _np(jqk.int8_conv2d_reference(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(ws), padding=padding, bias=jb,
                                        out_dtype=jnp.float32))
    tol = 2e-2 * np.abs(ref).max() + np.abs(ref) * 2.0 ** -8
    assert (np.abs(_np(got) - ref) <= tol).all()


def test_int8_conv2d_kernel_layout_is_the_jax_layout_transposed():
    x, wq, ws, padding, bias = _conv_case(CONV_CASES[2], 5)
    a = qk.int8_conv2d(torch.from_numpy(x), torch.from_numpy(wq), torch.from_numpy(ws), padding=padding,
                       bias=torch.from_numpy(bias), act="relu")
    wk = torch.from_numpy(np.ascontiguousarray(wq.transpose(3, 0, 1, 2)))
    b = qk.int8_conv2d_ohwi(torch.from_numpy(x), wk, torch.from_numpy(ws), ((2, 2), (2, 2)),
                            bias=torch.from_numpy(bias), act="relu")
    assert a.dtype == torch.float32 and torch.equal(a, b)


@pytest.mark.parametrize("padding", ["SAME", "VALID", ((0, 1), (2, 0)), "CIRCULAR", ((1,), (1, 1)), ((-1, 0), (0, 0))])
def test_conv_pads_is_the_jax_rule(padding):
    assert qk._conv_pads(padding, 3, 4) == jqk._conv_pads(padding, 3, 4)


def test_int8_conv2d_rejects_bad_arguments():
    x = torch.zeros(1, 5, 5, 3)
    wq = torch.zeros(3, 3, 3, 2, dtype=torch.int8)
    ws = torch.ones(2)
    with pytest.raises(ValueError, match="int8"):
        qk.int8_conv2d(x, wq.float(), ws)
    with pytest.raises(ValueError, match="channels"):
        qk.int8_conv2d(torch.zeros(1, 5, 5, 4), wq, ws)
    with pytest.raises(ValueError, match="w_scale"):
        qk.int8_conv2d(x, wq, torch.ones(3))
    with pytest.raises(ValueError, match="padding"):
        qk.int8_conv2d(x, wq, ws, padding="CIRCULAR")
    with pytest.raises(ValueError, match="empty output"):
        qk.int8_conv2d(torch.zeros(1, 1, 1, 3), wq, ws, padding="VALID")


# -- fused bias + act ---------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ACTS)
def test_fused_bias_act_plain_matches_jax(act, dtype):
    rng = np.random.default_rng(len(act))
    x = (rng.standard_normal((3, 5, 7, 33)) * 4).astype(np.float32)
    bias = rng.standard_normal(33).astype(np.float32)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    xt = torch.from_numpy(_np(xj)).to(getattr(torch, dtype))
    for b in (bias, None):
        got = tk.fused_bias_act(xt, None if b is None else torch.from_numpy(b), act)
        want = jpk.fused_bias_act_reference(xj, None if b is None else jnp.asarray(b), act=act)
        assert got.dtype == xt.dtype and got.shape == xt.shape
        assert close(_np(got), _np(want), dtype, act)


def test_fused_bias_act_rejects_bad_arguments():
    with pytest.raises(ValueError, match="bias"):
        tk.fused_bias_act(torch.zeros(2, 3), torch.zeros(2))
    with pytest.raises(ValueError, match="act"):
        tk.fused_bias_act(torch.zeros(2, 3), act="tanh")


# -- the fused_bias_act vector arm's plan and walk -----------------------------------------


@pytest.mark.parametrize(
    "c,dtype,aligned,vector",
    [(1536, torch.bfloat16, True, True), (8, torch.bfloat16, True, True), (12, torch.bfloat16, True, False),
     (1536, torch.float32, True, True), (4, torch.float32, True, True), (12, torch.float32, True, True),
     (6, torch.float32, True, False), (33, torch.float32, True, False), (1536, torch.bfloat16, False, False),
     (1536, torch.float32, False, False)],
)
def test_bias_act_plan_takes_whole_vectors_on_aligned_bases(c, dtype, aligned, vector):
    """The vector arm for C a multiple of 8 in bf16 and of 4 in float32 with
    16-byte aligned bases; the earlier kernel otherwise."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    plan = tk.bias_act_plan(64 * c, c, itemsize, aligned)
    assert (plan is not None) == vector
    if plan is not None:
        assert plan.vec * itemsize == 16 and plan.groups * plan.vec == c


def test_bias_act_plan_fills_one_wave_and_refuses_empty_tensors():
    # the ViT MLP hidden shape: one wave of 4 blocks on each of the 132 SMs
    for itemsize in (2, 4):
        plan = tk.bias_act_plan(12544 * 1536, 1536, itemsize, True)
        assert plan.blocks == tk.H100_SMS * tk.BIAS_ACT_BLOCKS_SM
        assert plan.rows * plan.groups == plan.blocks * tk.BIAS_ACT_THREADS
    # fewer rows than walkers: one walker a row
    assert tk.bias_act_plan(3 * 64, 64, 4, True).rows == 3
    assert tk.bias_act_plan(0, 64, 4, True) is None


def test_bias_act_route_reads_alignment_from_the_bases():
    flat = torch.zeros(37 * 64 + 1)
    out = torch.empty(37, 64)
    assert tk.bias_act_route(flat[:-1].view(37, 64), out) is not None
    assert tk.bias_act_route(flat[1:].view(37, 64), out) is None
    bf = torch.zeros(37 * 64 + 1, dtype=torch.bfloat16)
    assert tk.bias_act_route(bf[1:].view(37, 64), torch.empty(37, 64, dtype=torch.bfloat16)) is None


BIAS_ACT_UNROLL = 4  # csrc/bias_act.cu TFDL_BA_UNROLL: rows in flight a step


def _bias_act_walk(x2d, bias, act, plan):
    """The vector kernel's index walk, every thread at once: thread t (of
    ``plan.blocks`` x 256; those past ``rows * groups`` return) owns
    channels ``(t % groups) * vec`` on, starts at row ``t // groups`` and
    steps ``rows`` rows, ``BIAS_ACT_UNROLL`` rows a step. Returns the output
    and how often each element was written. The activation, the same
    function at every element, is applied once to the whole walked sum, so
    that PyTorch's CPU kernels take the path they take for the plain
    version (their vector body and scalar tail round sigmoid and gelu
    apart)."""
    p_rows, c = x2d.shape
    t = torch.arange(plan.blocks * tk.BIAS_ACT_THREADS)
    t = t[t < plan.rows * plan.groups]
    cols = ((t % plan.groups) * plan.vec)[:, None] + torch.arange(plan.vec)
    p = t // plan.groups
    summed = torch.empty(p_rows, c)
    hits = torch.zeros(p_rows, c, dtype=torch.int64)
    while bool((p < p_rows).any()):
        for u in range(BIAS_ACT_UNROLL):
            r = p + u * plan.rows
            live = r < p_rows
            rr, cc = r[live][:, None], cols[live]
            y = x2d[rr, cc].float()
            if bias is not None:
                y = y + bias[cc]
            summed[rr, cc] = y
            hits[rr, cc] += 1
        p = p + BIAS_ACT_UNROLL * plan.rows
    return tk.activate(summed.view(x2d.shape), act).to(x2d.dtype), hits


@pytest.mark.parametrize(
    "shape,dtype,rows",
    [((50, 24), torch.float32, None), ((9, 8), torch.bfloat16, 2), ((23, 48), torch.bfloat16, 3),
     ((17, 4), torch.float32, 5), ((2, 3, 7, 16), torch.float32, 1)],
)
@pytest.mark.parametrize("act", ACTS)
def test_bias_act_vector_walk_matches_the_plain_version(shape, dtype, rows, act):
    """The planner's own plan and forced ones with a few rows a walker (so a
    walker takes several steps and ragged last steps): every element written
    once, and the result bit for bit the plain version."""
    rng = np.random.default_rng(len(act) + shape[-1])
    x = torch.from_numpy((rng.standard_normal(shape) * 3).astype(np.float32)).to(dtype)
    bias = torch.from_numpy(rng.standard_normal(shape[-1]).astype(np.float32))
    c = shape[-1]
    plan = tk.bias_act_plan(x.numel(), c, x.element_size(), True)
    if rows is not None:
        plan = tk.BiasActPlan(plan.vec, plan.groups, rows, -(-rows * plan.groups // tk.BIAS_ACT_THREADS))
    x2d = x.reshape(-1, c)
    for b in (bias, None):
        out, hits = _bias_act_walk(x2d, b, act, plan)
        assert bool((hits == 1).all())
        want = tk.fused_bias_act_plain(x, b, act).reshape(-1, c)
        view = torch.int16 if dtype == torch.bfloat16 else torch.int32
        assert torch.equal(out.view(view), want.view(view))


# -- BatchNorm with bf16 parameters: flax's own order ------------------------------------


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_bn_act_unfolded_is_flax_batchnorm_with_bf16_statistics(x_dtype):
    rng = np.random.default_rng(4)
    c = 40
    x = (rng.standard_normal((2, 5, 6, c)) * 3).astype(np.float32)
    vec = dict(scale=rng.uniform(0.5, 1.5, c), bias=rng.standard_normal(c), mean=rng.standard_normal(c),
               var=rng.uniform(0.2, 3.0, c))
    v = {k: jnp.asarray(a.astype(np.float32), jnp.bfloat16) for k, a in vec.items()}
    bn = jnn.BatchNorm(use_running_average=True, epsilon=1e-3, dtype=jnp.float32)
    xj = jnp.asarray(x, getattr(jnp, x_dtype))
    want = jax.nn.relu(bn.apply({"params": {"scale": v["scale"], "bias": v["bias"]},
                                 "batch_stats": {"mean": v["mean"], "var": v["var"]}}, xj))
    t = {k: torch.from_numpy(_np(a)).to(torch.bfloat16) for k, a in v.items()}
    mean, mul, bias = tk.unfold_bn_bf16(t["scale"], t["bias"], t["mean"], t["var"], 1e-3)
    got = tk.bn_act_unfolded(torch.from_numpy(_np(xj)).to(getattr(torch, x_dtype)), mean, mul, bias, "relu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- dispatch and the module swap ---------------------------------------------------------


@pytest.mark.parametrize(
    "call",
    [
        lambda d: qk.int8_conv2d(torch.zeros(1, 4, 4, 2, device=d), torch.zeros(3, 3, 2, 2, dtype=torch.int8, device=d),
                                 torch.ones(2, device=d)),
        lambda d: qk.int8_matmul(torch.zeros(3, 4, device=d), torch.zeros(4, 2, dtype=torch.int8, device=d),
                                 torch.ones(2, device=d)),
        lambda d: tk.fused_bias_act(torch.zeros(2, 3, device=d), torch.zeros(3, device=d)),
        lambda d: tk.bn_act_unfolded(torch.zeros(1, 2, 2, 3, device=d), *[torch.ones(3, device=d)] * 3),
        lambda d: qk.int8_conv2d(torch.zeros(1, 4, 4, 16, device=d), torch.zeros(1, 1, 16, 2, dtype=torch.int8, device=d),
                                 torch.ones(2, device=d)),
        lambda d: qk.int8_conv2d(torch.zeros(1, 4, 4, 32, device=d), torch.zeros(3, 3, 32, 2, dtype=torch.int8, device=d),
                                 torch.ones(2, device=d)),
    ],
    ids=["int8_conv2d", "int8_matmul", "fused_bias_act", "bn_act_unfolded", "int8_conv2d_1x1", "int8_conv2d_3x3_cin32"],
)
def test_non_cpu_tensors_never_take_the_plain_version(call):
    with pytest.raises((ValueError, NotImplementedError, RuntimeError)):
        call("meta")


def jax_int8_eligible(mod) -> bool:
    """``make_int8_interceptor``'s rule for a flax module."""
    if not isinstance(mod, jnn.Conv):
        return False
    kh, kw = mod.kernel_size
    return (mod.feature_group_count == 1 and jqk._norm_pair(mod.strides) == (1, 1)
            and jqk._norm_pair(mod.kernel_dilation) == (1, 1) and jqk._conv_pads(mod.padding, kh, kw) is not None)


def _count_jax_int8_convs(cfg_kwargs, shape) -> int:
    """Eligible ``nn.Conv`` calls of the JAX model under
    ``make_int8_interceptor``'s rule, counted at trace time (no compute)."""
    from tensorflowdistributedlearning_tpu import config as jconfig
    from tensorflowdistributedlearning_tpu.models import build_model as jbuild

    jm = jbuild(jconfig.ModelConfig(**cfg_kwargs))
    x = jax.ShapeDtypeStruct(shape, jnp.float32)
    variables = jax.eval_shape(lambda a: jm.init(jax.random.key(0), a, train=False), x)
    count = [0]

    def intercept(next_fun, args, kwargs, context):
        if context.method_name == "__call__" and jax_int8_eligible(context.module):
            count[0] += 1
        return next_fun(*args, **kwargs)

    def apply(v, a):
        with jnn.intercept_methods(intercept):
            return jm.apply(v, a, train=False)

    jax.eval_shape(apply, variables, x)
    return count[0]


@pytest.mark.parametrize("cfg_kwargs", [dict(), dict(n_blocks=(1, 1, 1), width_multiplier=0.125, base_depth=16)],
                         ids=["full-width", "tiny"])
def test_eligible_convs_are_the_interceptors(cfg_kwargs):
    with torch.device("meta"):
        model = ResNetSegmentation(ModelConfig(**cfg_kwargs))
    ours = sum(qk.int8_eligible(m) for m in model.modules())
    jax_count = _count_jax_int8_convs(cfg_kwargs, (1, 101, 101, 2))
    assert ours == jax_count
    if not cfg_kwargs:
        assert ours == 52  # of the full-width model's 63 convs


def test_quant_conv_module_runs_the_int8_conv():
    x, wq, ws, _, bias = _conv_case(CONV_CASES[1], 9)
    q_oihw = torch.from_numpy(np.ascontiguousarray(wq.transpose(3, 2, 0, 1)))
    mod = qk.QuantConv2d(q_oihw, torch.from_numpy(ws), None, ((1, 1), (1, 1)))
    got = mod(torch.from_numpy(x))
    want = qk.int8_conv2d_plain(torch.from_numpy(x), torch.from_numpy(wq), torch.from_numpy(ws),
                                out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    jax_fn = functools.partial(jqk.int8_conv2d, out_dtype=jnp.bfloat16, interpret=True)
    assert ulps(_np(got), _np(jax_fn(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(ws))), "bfloat16") <= 1


# -- the route int8_matmul takes, and the C entry points' argument lists -------------------

# (M, K, N) of the ViT-S/16 int8-compute path at bucket 64: the four Dense
# shapes of a block (qkv, proj, fc1, fc2) and the logits
VIT_PATH_MKN = [(12544, 384, 1152), (12544, 384, 384), (12544, 384, 1536), (12544, 1536, 384), (64, 384, 1000)]


@pytest.mark.parametrize("mkn", VIT_PATH_MKN, ids=lambda s: "x".join(map(str, s)))
def test_vit_path_shapes_take_the_gemm(mkn):
    assert qk.matmul_route(mkn[1]) == "gemm"


@pytest.mark.parametrize("k", [70, 33, 5])
def test_shapes_tma_cannot_describe_take_the_conv_kernel(k):
    """K % 16 != 0: the [M, K] rows are not 16-byte aligned, which TMA's
    tensor maps need; the odd sweep of the card's checks has these K."""
    assert qk.matmul_route(k) == "conv"


def _c_entries():
    """``{name: (source stem, argument count)}`` of every ``extern "C" int``
    entry point in ``csrc/*.cu``."""
    import re

    from tensorflowdistributedlearning_tpu_torch.ops import _build

    entries = {}
    for stem, path in _build.sources().items():
        with open(path) as f:
            text = f.read()
        for name, args in re.findall(r'extern "C" int (tfdl_\w+)\s*\(([^)]*)\)', text):
            entries[name] = (stem, len([a for a in args.split(",") if a.strip()]))
    return entries


@pytest.mark.parametrize("entry", sorted(tk._signatures))
def test_c_entry_points_match_their_ctypes_signatures(entry):
    """A binding with the wrong argument count would only show on the card
    (ctypes passes what it is told): each entry's C definition has as many
    parameters as its ``_signatures`` argtypes, in the library it names."""
    lib, argtypes = tk._signatures[entry]
    assert _c_entries()[entry] == (lib, len(argtypes))


def test_every_c_entry_point_has_a_binding():
    assert set(_c_entries()) == set(tk._signatures)


# -- the route int8_conv2d takes --------------------------------------------------------


def _full_width_conv_routes():
    """``{layer: route}`` of the full-width segmenter's int8-eligible convs,
    from their shapes alone (no forward)."""
    with torch.device("meta"):
        model = ResNetSegmentation(ModelConfig())
    routes = {}
    for name, mod in model.named_modules():
        if qk.int8_eligible(mod):
            kh, kw = mod.kernel_size
            routes[name] = qk.conv_route(kh, kw, mod.in_channels, qk._conv_pads(mod.same_padding, kh, kw))
    return routes


def test_full_width_convs_route_43_to_the_gemm_and_9_to_the_im2col_kernel():
    """The 52 int8 convs of ``ModelConfig()``: every 1x1 (Cin 128 to 2048)
    through int8_gemm.cu, every 3x3 (Cin 64, 128, 256, 512; the decoder's
    Cout 1 included) through int8_conv_tc.cu, none through int8_conv.cu."""
    routes = _full_width_conv_routes()
    assert len(routes) == 52
    kxk = sorted(name for name, route in routes.items() if route == "tc")
    assert sum(route == "gemm" for route in routes.values()) == 43
    assert kxk == sorted(["backbone.conv1_2.conv", "backbone.conv1_3.conv", "backbone.block1_unit1.conv2.conv",
                          "backbone.block1_unit2.conv2.conv", "backbone.block2_unit1.conv2.conv",
                          "backbone.block2_unit2.conv2.conv", "backbone.block2_unit3.conv2.conv",
                          "backbone.block2_unit4.conv2.conv", "decoder_conv_3x3"])


SAME3, ZERO = ((1, 1), (1, 1)), ((0, 0), (0, 0))


@pytest.mark.parametrize(
    "kh,kw,cin,pads,aligned,route",
    [
        (1, 1, 128, ZERO, True, "gemm"),  # the path's 1x1 convs
        (1, 1, 48, ZERO, True, "gemm"),  # Cin a multiple of 16 is a TMA row
        (1, 1, 5, ZERO, True, "conv"),  # rows TMA cannot describe
        (1, 1, 96, ((1, 0), (0, 2)), True, "tc"),  # a 1x1 with pads is no plain GEMM
        (1, 1, 48, ((1, 0), (0, 0)), True, "conv"),  # ... and Cin 48 is no whole swizzle row
        (3, 3, 64, SAME3, True, "tc"),  # 64-byte slices
        (3, 3, 512, SAME3, True, "tc"),  # 128-byte slices
        (3, 3, 96, SAME3, True, "tc"),  # 32-byte slices
        (3, 3, 16, SAME3, True, "conv"),
        (3, 3, 3, SAME3, True, "conv"),
        (5, 5, 64, ((2, 0), (1, 3)), True, "tc"),  # asymmetric explicit pads
        (3, 3, 64, ((200, 0), (0, 0)), True, "conv"),  # a corner past a signed byte
        (1, 1, 128, ZERO, False, "conv"),  # an unaligned base
        (3, 3, 64, SAME3, False, "conv"),
    ],
)
def test_conv_route_branches(kh, kw, cin, pads, aligned, route):
    assert qk.conv_route(kh, kw, cin, pads, aligned) == route


# -- the BN + act row kernels' two arms --------------------------------------------------


def test_bn_act_vectorized_needs_channels_in_fours_and_aligned_bases():
    x = torch.zeros(2, 3, 3, 8)
    vec = torch.zeros(8)
    assert tk.bn_act_vectorized(8, x, vec, vec, None, x)
    assert not tk.bn_act_vectorized(33, torch.zeros(2, 3, 3, 33))
    assert not tk.bn_act_vectorized(6, torch.zeros(2, 3, 3, 6))
    flat = torch.zeros(2 * 3 * 3 * 8 + 1)
    unaligned = flat[1:].view(2, 3, 3, 8)
    assert unaligned.data_ptr() % 16 != 0
    assert not tk.bn_act_vectorized(8, x, unaligned)
    bf = torch.zeros(2 * 3 * 3 * 8 + 1, dtype=torch.bfloat16)[1:].view(2, 3, 3, 8)
    assert not tk.bn_act_vectorized(8, bf, vec)


@pytest.mark.parametrize(
    "call",
    [
        lambda: tk._earlier_bn_act(torch.zeros(1, 2, 2, 4), torch.ones(4), torch.zeros(4)),
        lambda: tk._earlier_bn_act_unfolded(torch.zeros(1, 2, 2, 4), *[torch.ones(4)] * 3),
        lambda: tk._earlier_fused_bias_act(torch.zeros(2, 8), torch.ones(8), "gelu"),
        lambda: qk._earlier_int8_conv(torch.zeros(1, 4, 4, 16, dtype=torch.int8), torch.ones(()),
                                      torch.zeros(2, 3, 3, 16, dtype=torch.int8), torch.ones(2), None,
                                      torch.zeros(1, 4, 4, 2), SAME3, "none"),
    ],
    ids=["bn_act", "bn_act_unfolded", "fused_bias_act", "int8_conv2d"],
)
def test_earlier_kernels_take_only_cuda_tensors(call):
    """The earlier kernels are kept to be timed beside the new ones on the
    card; they have no plain arm."""
    with pytest.raises(ValueError, match="CUDA"):
        call()


@pytest.mark.parametrize(
    "args,match",
    [
        ((torch.zeros(1, 2, 2, 4), torch.ones(4), torch.zeros(5)), "b must be"),
        ((torch.zeros(2, 2, 4), torch.ones(4), torch.zeros(4)), "B, H, W, C"),
    ],
)
def test_bn_act_folded_rejects_bad_arguments(args, match):
    with pytest.raises(ValueError, match=match):
        tk.bn_act_folded(*args)


def test_bn_act_unfolded_rejects_vectors_of_another_width():
    with pytest.raises(ValueError, match="mul must be"):
        tk.bn_act_unfolded(torch.zeros(1, 2, 2, 4), torch.ones(4), torch.ones(3), torch.ones(4))
