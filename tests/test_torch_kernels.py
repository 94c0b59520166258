"""The port's kernels: plain versions against the JAX Pallas kernels (run
in interpret mode, as tests/test_kernels.py runs them on the CPU) and
against the reference oracles in ``repro.kernels.ref``; the dispatch
rules; and, on a CUDA card, each Hopper kernel against its plain version.

Tolerances: float32 1e-6 (absolute and relative) between the plain
versions and the reference, and 2e-5 between a Hopper kernel and its plain
version on the card (sums taken in another order). The WKV recurrence is
held at 1e-5 of its output's scale, max(1, max|ref|), against the
reference and 2e-5 of it on the card: y sums products of magnitude up to
max|y| over a chunk and the state, so float32 round-off sits at that scale
and an entry near zero (cancellation) carries it too. bfloat16 one unit in
the last place of the reference output (both sides accumulate in float32
and round once, so a last-bit difference in float32 may flip one bf16
rounding). Outputs below 1/256 of the tensor's largest magnitude come out
of cancellation, where float32 round-off alone exceeds their own ulp, so
they are held to the ulp at that floor.

The reference is imported when available: the card-only tests at the end
need no JAX and run on a machine with a card and no JAX
(``pytest -m gpu tests/test_torch_kernels.py``).
"""

import ctypes
import math
import os

import numpy as np
import pytest
import torch

try:  # the JAX reference; absent on a card machine without JAX
    import jax
    import jax.numpy as jnp
    from repro.kernels.flash_attention import flash_attention as j_flash
    from repro.kernels.ref import (flash_attention_ref, sa_fused_update_ref,
                                   sa_update_ref, wkv_ref)
    from repro.kernels.rwkv6_scan import rwkv6_wkv as j_wkv
    from repro.kernels.sa_fused import sa_fused_update as j_sa_fused
    from repro.kernels.sa_update import sa_update as j_sa_update
except ImportError:  # pragma: no cover - exercised on the card machine
    jax = None

from repro_torch.kernels import flash_attention as t_flash_mod
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6_scan as t_wkv_mod
from repro_torch.kernels import sa_fused as t_fused_mod
from repro_torch.kernels import sa_update as t_update_mod


@pytest.fixture
def reference():
    if jax is None:
        pytest.skip("the JAX reference is not installed here")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _ulp_bf16(ref):
    a = np.abs(np.asarray(ref, np.float32))
    a = np.maximum(a, max(float(a.max()) * 2.0 ** -8, 2.0 ** -126))
    return np.exp2(np.floor(np.log2(a)) - 7)


def assert_close(got, ref, dtype_name, tol=1e-6):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    if dtype_name == "bfloat16":
        assert (np.abs(got - ref) <= _ulp_bf16(ref)).all(), \
            float(np.abs(got - ref).max())
    else:
        np.testing.assert_allclose(got, ref, atol=tol, rtol=tol)


def _pair(a, dtype_name):
    """The same values as a jnp and a torch array of ``dtype_name``."""
    j = jnp.asarray(a).astype(getattr(jnp, dtype_name))
    t = torch.from_numpy(np.array(a)).to(getattr(torch, dtype_name))
    return j, t


def _to_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ------------------------------------------------------------ sa_update
@pytest.mark.parametrize("shape", [(64,), (4, 100, 7), (2, 33, 5, 3), (1,)])
@pytest.mark.parametrize("P", [1, 3, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sa_update_plain_matches_pallas(reference, shape, P, dtype):
    rng = np.random.default_rng(P * 100 + len(shape))
    (xj, xt), (bj, bt), (ij, it) = (_pair(rng.standard_normal(s), dtype)
                                    for s in (shape, (P,) + shape, shape))
    c = np.asarray([0.9, 0.1] + [0.3 / (j + 1) for j in range(P)], np.float32)
    got = t_update_mod.sa_update_plain(xt, bt, it, torch.from_numpy(c))
    assert got.dtype == xt.dtype
    pallas = j_sa_update(xj, bj, ij, jnp.asarray(c), tile=128)
    assert_close(_to_np(got), _to_np(pallas), dtype)
    assert_close(_to_np(got), _to_np(sa_update_ref(xj, bj, ij, jnp.asarray(c))),
                 dtype)


# ------------------------------------------------------------- sa_fused
@pytest.mark.parametrize("shape", [(64,), (4, 100, 7), (1,)])
@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sa_fused_plain_matches_pallas(reference, shape, P, dtype):
    rng = np.random.default_rng(7 + P)
    (xj, xt), (bj, bt), (ij, it) = (_pair(rng.standard_normal(s), dtype)
                                    for s in (shape, (P,) + shape, shape))
    c = np.asarray([[0.9, 0.1] + [0.3 / (j + 1) for j in range(P)],
                    [0.9, 0.1] + [-0.2 * (j + 1) for j in range(P)]],
                   np.float32)
    got_p, got_c = t_fused_mod.sa_fused_update_plain(xt, bt, it,
                                                     torch.from_numpy(c))
    ref_p, ref_c = j_sa_fused(xj, bj, ij, jnp.asarray(c), tile=128)
    orc_p, orc_c = sa_fused_update_ref(xj, bj, ij, jnp.asarray(c))
    tol = 2e-6  # the reference's own fused-vs-oracle bar
    for got, ref in ((got_p, ref_p), (got_c, ref_c), (got_p, orc_p),
                     (got_c, orc_c)):
        assert_close(_to_np(got), _to_np(ref), dtype, tol)


@pytest.mark.parametrize("P", [6, 8, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_plains_match_pallas_past_five_rows(reference, P, dtype):
    """History widths past the kernels' template instances (the card runs
    them through the runtime-P kernel): both plain versions against the
    Pallas kernels and the reference oracles, as at P 1..5."""
    rng = np.random.default_rng(50 + P)
    shape = (4, 100, 7)
    (xj, xt), (bj, bt), (ij, it) = (_pair(rng.standard_normal(s), dtype)
                                    for s in (shape, (P,) + shape, shape))
    c = np.asarray([[0.9, 0.1] + [0.3 / (j + 1) for j in range(P)],
                    [0.9, 0.1] + [-0.2 * (j + 1) for j in range(P)]],
                   np.float32)
    got = t_update_mod.sa_update_plain(xt, bt, it, torch.from_numpy(c[0]))
    for want in (j_sa_update(xj, bj, ij, jnp.asarray(c[0]), tile=128),
                 sa_update_ref(xj, bj, ij, jnp.asarray(c[0]))):
        assert_close(_to_np(got), _to_np(want), dtype)
    got_p, got_c = t_fused_mod.sa_fused_update_plain(xt, bt, it,
                                                     torch.from_numpy(c))
    ref_p, ref_c = j_sa_fused(xj, bj, ij, jnp.asarray(c), tile=128)
    orc_p, orc_c = sa_fused_update_ref(xj, bj, ij, jnp.asarray(c))
    for got, ref in ((got_p, ref_p), (got_c, ref_c), (got_p, orc_p),
                     (got_c, orc_c)):
        assert_close(_to_np(got), _to_np(ref), dtype, 2e-6)


def test_sa_fused_rows_match_single_combines(reference):
    """Each fused output equals the single combine with the same packed
    row: the dual kernel is two sa_updates in one pass."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal(512).astype(np.float32))
    buf = torch.from_numpy(rng.standard_normal((3, 512)).astype(np.float32))
    xi = torch.from_numpy(rng.standard_normal(512).astype(np.float32))
    c = torch.tensor([[0.8, 0.2, 0.1, -0.2, 0.3],
                      [0.8, 0.2, 0.4, 0.1, -0.1]])
    pred, corr = t_fused_mod.sa_fused_update_plain(x, buf, xi, c)
    for out, row in ((pred, c[0]), (corr, c[1])):
        ref = sa_update_ref(jnp.asarray(x.numpy()), jnp.asarray(buf.numpy()),
                            jnp.asarray(xi.numpy()), jnp.asarray(row.numpy()))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   atol=2e-6, rtol=2e-6)
        np.testing.assert_allclose(
            out.numpy(), t_update_mod.sa_update_plain(x, buf, xi, row).numpy(),
            atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("n", [1, 7, 130, 2800, 5003])
def test_sa_update_unaligned_sizes(reference, n):
    rng = np.random.default_rng(n)
    x, buf, xi = (rng.standard_normal(s).astype(np.float32)
                  for s in ((n,), (2, n), (n,)))
    c = np.asarray([0.7, 0.1, 0.5, -0.3], np.float32)
    ref = j_sa_update(jnp.asarray(x), jnp.asarray(buf), jnp.asarray(xi),
                      jnp.asarray(c), tile=256)
    got = t_update_mod.sa_update_plain(*(torch.from_numpy(a)
                                         for a in (x, buf, xi, c)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-6)


# -------------------------------------------------------- flash attention
def _attn(rng, B, H, K, S, T, hd, dtype):
    return tuple(_pair(rng.standard_normal(s), dtype)
                 for s in ((B, H, S, hd), (B, K, T, hd), (B, K, T, hd)))


@pytest.mark.parametrize("B,H,K,S,hd,bq,bk", [
    (2, 4, 4, 128, 64, 32, 32),    # MHA
    (1, 8, 2, 256, 32, 64, 64),    # GQA 4:1
    (2, 4, 1, 64, 16, 16, 16),     # MQA
    (1, 2, 2, 128, 128, 64, 32),   # bq != bk
    (1, 4, 2, 64, 72, 32, 32),     # DiT-XL/2's head dim
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas(reference, B, H, K, S, hd, bq,
                                              bk, dtype):
    rng = np.random.default_rng(S + hd)
    (qj, qt), (kj, kt), (vj, vt) = _attn(rng, B, H, K, S, S, hd, dtype)
    got = t_flash_mod.flash_attention_plain(qt, kt, vt, causal=True)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    pallas = j_flash(qj, kj, vj, causal=True, bq=bq, bk=bk)
    assert_close(_to_np(got), _to_np(pallas), dtype)
    assert_close(_to_np(got), _to_np(flash_attention_ref(qj, kj, vj)), dtype)


@pytest.mark.parametrize("S", [19, 24, 33])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_ragged_lengths(reference, S, causal, dtype):
    rng = np.random.default_rng(5 + S)
    (qj, qt), (kj, kt), (vj, vt) = _attn(rng, 1, 2, 2, S, S, 16, dtype)
    got = t_flash_mod.flash_attention_plain(qt, kt, vt, causal=causal)
    pallas = j_flash(qj, kj, vj, causal=causal, bq=16, bk=16)
    assert_close(_to_np(got), _to_np(pallas), dtype)


@pytest.mark.parametrize("S,causal", [(48, True), (48, False), (33, True),
                                      (33, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas_at_head_dim_256(reference, S,
                                                              causal, dtype):
    """gemma-7b's head dim, which has a kernel instance: GQA 2:1, both
    masks, a ragged length, against the Pallas kernel in interpret mode
    and the reference oracle. float32 is held at 1e-5 of the output's
    scale, max(1, max|ref|), as the WKV is: each score sums 256 products,
    which XLA and PyTorch block in other orders, and an output entry near
    zero (cancellation) carries that round-off (up to 2.3e-6 from either,
    over 1e-6 absolute plus relative on 2-13 entries)."""
    assert 256 in t_flash_mod.HEAD_DIMS
    rng = np.random.default_rng(256 + S)
    (qj, qt), (kj, kt), (vj, vt) = _attn(rng, 1, 4, 2, S, S, 256, dtype)
    got = t_flash_mod.flash_attention_plain(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    pallas = j_flash(qj, kj, vj, causal=causal, bq=16, bk=16)
    ref = flash_attention_ref(qj, kj, vj, causal=causal)
    for want in (pallas, ref):
        if dtype == "float32":
            assert_scale_close(got, _to_np(want), 1e-5)
        else:
            assert_close(_to_np(got), _to_np(want), dtype)


@pytest.mark.parametrize("S,causal", [(40, True), (40, False), (33, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas_at_head_dim_224(reference, S,
                                                              causal, dtype):
    """zamba2-7b's shared attention (2 x 3584 / 32 heads), which has a
    kernel instance: GQA 2:1, both masks, a ragged length, against the
    Pallas kernel in interpret mode and the reference oracle, held as at
    head dim 256."""
    assert 224 in t_flash_mod.HEAD_DIMS
    rng = np.random.default_rng(224 + S)
    (qj, qt), (kj, kt), (vj, vt) = _attn(rng, 1, 4, 2, S, S, 224, dtype)
    got = t_flash_mod.flash_attention_plain(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    pallas = j_flash(qj, kj, vj, causal=causal, bq=8, bk=8)
    ref = flash_attention_ref(qj, kj, vj, causal=causal)
    for want in (pallas, ref):
        if dtype == "float32":
            assert_scale_close(got, _to_np(want), 1e-5)
        else:
            assert_close(_to_np(got), _to_np(want), dtype)


@pytest.mark.parametrize("hd", [8, 20, 40, 100, 200, 250])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_pallas_at_any_head_dim(reference, hd,
                                                              causal):
    """Head dims without a kernel instance of their own (the card runs
    them through the smallest instance that holds them): GQA 2:1, a
    ragged length, against the Pallas kernel in interpret mode and the
    reference oracle, float32 held as at head dim 256."""
    rng = np.random.default_rng(hd)
    (qj, qt), (kj, kt), (vj, vt) = _attn(rng, 1, 4, 2, 33, 33, hd,
                                         "float32")
    got = t_flash_mod.flash_attention_plain(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    pallas = j_flash(qj, kj, vj, causal=causal, bq=8, bk=8)
    ref = flash_attention_ref(qj, kj, vj, causal=causal)
    for want in (pallas, ref):
        assert_scale_close(got, _to_np(want), 1e-5)


def test_flash_instance_for_takes_the_smallest_instance_that_holds_hd():
    """Every head dim 1..256 routes to the smallest instance at least as
    wide (an instanced one to itself); 0 and 257 are refused with the
    reference's documented range."""
    route = t_flash_mod.instance_for
    for hd in range(1, 257):
        inst = route(hd)
        assert inst in t_flash_mod.HEAD_DIMS and inst >= hd
        assert all(d < hd for d in t_flash_mod.HEAD_DIMS if d < inst)
    assert {hd: route(hd) for hd in (1, 8, 16, 17, 20, 33, 40, 64, 65, 72,
                                     73, 100, 129, 136, 200, 224, 225, 250,
                                     256)} == {
        1: 16, 8: 16, 16: 16, 17: 32, 20: 32, 33: 64, 40: 64, 64: 64,
        65: 72, 72: 72, 73: 80, 100: 128, 129: 224, 136: 224, 200: 224,
        224: 224, 225: 256, 250: 256, 256: 256}
    for hd in (0, 257):
        with pytest.raises(ValueError, match=r"1\.\.256.*hd <= 256"):
            route(hd)


def test_flash_dispatch_has_an_instance_for_every_head_dim():
    """The .cu dispatch's cases are exactly ``HEAD_DIMS`` (224 among
    them): a head dim the wrapper passes has an instance, and one it
    refuses has none."""
    import re
    src = open(os.path.join(os.path.dirname(t_flash_mod.__file__), "csrc",
                            "flash_attention.cu")).read()
    cases = tuple(int(c) for c in re.findall(
        r"case (\d+): return launch<T, \1>", src))
    assert cases == t_flash_mod.HEAD_DIMS
    assert 224 in cases and 232 not in cases


@pytest.mark.parametrize("hd", [32, 72])
def test_flash_attention_noncausal(reference, hd):
    rng = np.random.default_rng(2)
    (qj, qt), (kj, kt), (vj, vt) = _attn(rng, 1, 2, 2, 64, 64, hd, "float32")
    got = t_flash_mod.flash_attention_plain(qt, kt, vt, causal=False)
    pallas = j_flash(qj, kj, vj, causal=False, bq=32, bk=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=1e-6,
                               rtol=1e-6)


def _tf32(x):
    """cvt.rna.tf32.f32 on float32 values: keep 10 mantissa bits, rounding
    to nearest with ties away from zero (add half of the dropped 13 bits to
    the magnitude, then clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(x):
    """float32 values read as TF32 by dropping the low 13 bits."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _tf32_matmul(a, b, products):
    """a @ b in float32 from TF32 operands, one mma.sync per product:
    big·big alone, or big·big + big·small + small·big with a = big + small,
    big = a rounded to TF32 and small = a - big as the tensor core reads it
    (at worst truncated to TF32). Products of TF32 values are exact in
    float64, so only the operands' rounding is emulated."""
    ab, bb = _tf32(a), _tf32(b)
    out = ab.double() @ bb.double()
    if products == 3:
        out = (out + ab.double() @ _tf32_trunc(b - bb).double()
               + _tf32_trunc(a - ab).double() @ bb.double())
    return out.float()


@pytest.mark.parametrize("hd,scale", [(64, 1.0), (72, 1.0), (128, 1.0),
                                      (72, 10.0)])
def test_three_tf32_products_hold_attention_f32(hd, scale):
    """The Hopper flash kernel's arithmetic against the card-side tolerance
    to the float32 plain version, 2e-5 · max(1, max|plain|): scores as
    float32 FMA chains (the plain version's own), P·V as three TF32
    tensor-core products per multiply-add. One TF32 product for P·V misses
    the tolerance. At DiT-XL/2-like activations (``scale`` 10: |q|, |k| up
    to ~45, logits up to ~500) scores from three TF32 products miss it too,
    which is why the kernel keeps Q·K^T off the tensor cores."""
    rng = np.random.default_rng(hd)
    q, k, v = (scale * torch.from_numpy(rng.standard_normal((1, 4, 256, hd))
                                        .astype(np.float32)) for _ in range(3))
    plain = t_flash_mod.flash_attention_plain(q, k, v, causal=False)
    tol = 2e-5 * max(1.0, float(plain.abs().max()))

    def error(score_products, pv_products):
        if score_products:
            s = _tf32_matmul(q, k.transpose(-1, -2), score_products)
        else:
            s = torch.einsum("bhsd,bhtd->bhst", q, k)
        s = s / np.sqrt(hd)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        out = _tf32_matmul(p, v, pv_products) / p.sum(-1, keepdim=True)
        return float((out - plain).abs().max())

    kernel, one_tf32 = error(0, 3), error(0, 1)
    assert kernel <= tol, (kernel, tol)
    assert one_tf32 > tol, (one_tf32, tol)
    if scale > 1:
        tensor_core_scores = error(3, 3)
        assert tensor_core_scores > tol, (tensor_core_scores, tol)


# ------------------------------------------------------------- rwkv6 wkv
def _wkv_inputs(rng, B, T, H, hd, S0_zero=False, decay_shift=0.0):
    """r, k, v, logw [B,T,H,hd], u [H,hd], S0 [B,H,hd,hd] as float32 numpy,
    logw drawn as the reference's tests draw it, less ``decay_shift`` in
    the exponent (at 4, logw is about -0.02 and the state carries across
    chunks; at 0 a chunk of 16 or more tokens mostly forgets it)."""
    r, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32)
               for _ in range(3))
    logw = np.clip(-np.exp(rng.standard_normal((B, T, H, hd)) - decay_shift),
                   -8.0, -1e-5).astype(np.float32)
    u = rng.standard_normal((H, hd)).astype(np.float32)
    S0 = (np.zeros if S0_zero else rng.standard_normal)(
        (B, H, hd, hd)).astype(np.float32)
    return r, k, v, logw, u, S0


def assert_scale_close(got, ref, tol):
    """|got - ref| <= tol * max(1, max|ref|) everywhere."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    err = float(np.abs(got - ref).max())
    assert err <= tol * max(1.0, float(np.abs(ref).max())), err


@pytest.mark.parametrize("B,T,H,hd,chunk", [
    (2, 64, 3, 16, 16),
    (1, 128, 2, 32, 32),
    (3, 32, 1, 8, 16),
])
@pytest.mark.parametrize("decay_shift", [0.0, 4.0])
def test_wkv_plain_matches_pallas(reference, B, T, H, hd, chunk, decay_shift):
    """The reference's sweep (tests/test_kernels.py), and the same with slow
    decay: the plain version against the Pallas kernel in interpret mode
    and the sequential oracle."""
    arrs = _wkv_inputs(np.random.default_rng(B * T + hd), B, T, H, hd,
                       decay_shift=decay_shift)
    y, S = t_wkv_mod.rwkv6_wkv_plain(*map(torch.from_numpy, arrs),
                                     chunk=chunk)
    assert y.dtype == S.dtype == torch.float32
    jin = [jnp.asarray(a) for a in arrs]
    for y_ref, S_ref in (j_wkv(*jin, chunk=chunk), wkv_ref(*jin)):
        assert_scale_close(y.numpy(), y_ref, 1e-5)
        assert_scale_close(S.numpy(), S_ref, 1e-5)


def test_wkv_plain_bf16_inputs_match_pallas(reference):
    """bfloat16 r/k/v (logw float32, as the reference's bf16 test has it):
    both sides upcast the same values and accumulate in float32."""
    r, k, v, logw, u, S0 = _wkv_inputs(np.random.default_rng(4), 1, 32, 2, 16,
                                       S0_zero=True)
    (rj, rt), (kj, kt), (vj, vt) = (_pair(a, "bfloat16") for a in (r, k, v))
    y, S = t_wkv_mod.rwkv6_wkv_plain(rt, kt, vt, torch.from_numpy(logw),
                                     torch.from_numpy(u), torch.from_numpy(S0),
                                     chunk=16)
    rest = [jnp.asarray(a) for a in (logw, u, S0)]
    for y_ref, S_ref in (j_wkv(rj, kj, vj, *rest, chunk=16),
                         wkv_ref(rj, kj, vj, *rest)):
        assert_scale_close(y.numpy(), y_ref, 1e-5)
        assert_scale_close(S.numpy(), S_ref, 1e-5)


def test_wkv_plain_needs_whole_chunks():
    arrs = [torch.from_numpy(a) for a in
            _wkv_inputs(np.random.default_rng(0), 1, 48, 1, 16)]
    with pytest.raises(ValueError, match="divisible"):
        ops.wkv(*arrs, chunk=32)


def _cumsum_shuffle(x):
    """Inclusive cumsum along the last axis (C <= 64) in the order of a
    warp-shuffle scan: each of 32 lanes sums its C/32 values, a
    Kogge-Stone scan over the lanes, then each lane adds its prefix."""
    C = x.shape[-1]
    per = max(1, C // 32)
    n = C // per
    xs = x.reshape(*x.shape[:-1], n, per)
    part = [xs[..., 0]]
    for j in range(1, per):
        part.append(part[-1] + xs[..., j])
    p = part[-1].clone()
    off = 1
    while off < n:
        shifted = torch.zeros_like(p)
        shifted[..., off:] = p[..., :-off]
        p = torch.where(torch.arange(n) >= off, shifted + p, p)
        off *= 2
    excl = torch.zeros_like(p)
    excl[..., 1:] = p[..., :-1]
    out = [excl + q for q in part[:-1]] + [p]
    return torch.stack(out, -1).reshape(x.shape)


def _wkv_hopper_emulation(r, k, v, logw, u, S0, chunk, scan="time"):
    """The Hopper WKV kernel's arithmetic in plain PyTorch: every chunk's
    terms at once (the pairwise scores summed over the two interleaved
    4-column halves of the head dim, as two lanes share most tiles; the
    bonus on A's diagonal; U_c = (k exp(Ltot - L))^T v), then the state
    chain S_c = exp(Ltot_c) S_{c-1} + U_c, then y = A v +
    (r exp(Lprev)) S_{c-1} as one accumulation. The three products are
    three TF32 products each. ``scan`` is the order of the cumulative sum:
    "time" (the kernel's and the plain version's) or "shuffle"."""
    B, T, H, hd = r.shape
    nc = T // chunk
    per_chunk = lambda a: a.float().reshape(B, nc, chunk, H, hd).permute(
        0, 3, 1, 2, 4)                                     # [B,H,nc,C,hd]
    rc, kc, vc, lw = map(per_chunk, (r, k, v, logw))
    if scan == "time":
        L = torch.cumsum(lw, dim=3)
    else:
        L = _cumsum_shuffle(lw.transpose(3, 4)).transpose(3, 4)
    Lprev = L - lw
    Ltot = L[:, :, :, -1]
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool), -1)
    D = torch.where(tri[..., None], Lprev[..., :, None, :] - L[..., None, :, :],
                    -torch.inf)
    terms = rc[..., :, None, :] * kc[..., None, :, :] * torch.exp(D)
    half = ((torch.arange(hd) // 4) % 2).bool()
    A = terms[..., ~half].sum(-1) + terms[..., half].sum(-1)
    A = A + torch.diag_embed((rc * u.float()[None, :, None, None] * kc).sum(-1))
    r_dec = rc * torch.exp(Lprev)
    k_dec = kc * torch.exp(Ltot[..., None, :] - L)
    U = _tf32_matmul(k_dec.transpose(-1, -2), vc, 3)
    S, entering = S0.float(), []
    for c in range(nc):
        entering.append(S)
        S = torch.exp(Ltot[:, :, c])[..., None] * S + U[:, :, c]
    y = _tf32_matmul(torch.cat([A, r_dec], -1),
                     torch.cat([vc, torch.stack(entering, 2)], -2), 3)
    return y.permute(0, 2, 3, 1, 4).reshape(B, T, H, hd), S


def _tame_block_wkv_inputs():
    """The WKV inputs of the first block of a tame RWKV6 smoke denoiser
    (hd 32, chunk 64) over a latent [1, 256, 16], forward direction."""
    from repro_torch.models import rwkv6 as t_rwkv6
    from repro_torch.models.tame import tame_rwkv6
    model, params, mu = tame_rwkv6(n_layers=1, device="cpu")
    calls = []
    orig = t_rwkv6.wkv_chunked
    t_rwkv6.wkv_chunked = lambda *a: calls.append(a) or orig(*a)
    try:
        z = torch.from_numpy(np.random.default_rng(7).standard_normal(
            (1, 256, 16)).astype(np.float32))
        model.denoise(params, z, 0.5)
    finally:
        t_rwkv6.wkv_chunked = orig
    return calls[0][:6], calls[0][6]


@pytest.mark.parametrize("case", ["tame_block", "decay_shift_0",
                                  "clamp_floor", "beyond_clamp"])
def test_wkv_hopper_decomposition_holds_plain_and_pallas(reference, case):
    """The redesigned kernel's arithmetic (chunk-parallel terms, the U_c
    state chain, three TF32 products) within the card-side tolerance
    2e-5 · max(1, max|ref|) of the plain version and of the Pallas kernel
    in interpret mode: at the activations of a tame RWKV6 smoke block, and
    with a nonzero S0 at the model's decays and at decays mostly at its
    clamp (-8). Beyond the clamp (decays down to -50, which the kernel's
    contract takes) the plain version and the Pallas kernel are 4.7e-5
    apart themselves (the f32 rounding of L near -3000 differs), so there
    the emulation is held to the plain version only; and a cumulative sum
    in warp-shuffle order instead of time order misses the tolerance: it
    feeds the exponents, which is why the kernel keeps the plain version's
    order."""
    if case == "tame_block":
        args, chunk = _tame_block_wkv_inputs()
        args = tuple(a.contiguous() for a in args)
    else:
        shift, floor = {"decay_shift_0": (0.0, -8.0),
                        "clamp_floor": (-3.0, -8.0),
                        "beyond_clamp": (-3.0, -50.0)}[case]
        rng = np.random.default_rng(11)
        r, k, v, _, u, S0 = _wkv_inputs(rng, 2, 256, 2, 64)
        logw = np.clip(-np.exp(rng.standard_normal(r.shape) - shift), floor,
                       -1e-5).astype(np.float32)
        args, chunk = tuple(map(torch.from_numpy, (r, k, v, logw, u, S0))), 64
    y, S = _wkv_hopper_emulation(*args, chunk)
    refs = [t_wkv_mod.rwkv6_wkv_plain(*args, chunk=chunk)]
    if case != "beyond_clamp":
        jy, jS = j_wkv(*[jnp.asarray(a.numpy()) for a in args], chunk=chunk)
        refs.append((np.array(jy), np.array(jS)))
    for ref_y, ref_S in refs:
        assert_scale_close(y.numpy(), _to_np(ref_y), 2e-5)
        assert_scale_close(S.numpy(), _to_np(ref_S), 2e-5)
    if case == "beyond_clamp":
        y_sh, _ = _wkv_hopper_emulation(*args, chunk, scan="shuffle")
        plain_y = refs[0][0]
        err = float((y_sh - plain_y).abs().max())
        assert err > 2e-5 * max(1.0, float(plain_y.abs().max())), err


# ------------------------------------------------------------ dispatch
def test_ops_dispatch_cpu_takes_plain_and_counts_no_launch():
    ops.reset_launch_counts()
    x = torch.randn(4, 8)
    buf = torch.randn(3, 4, 8)
    c = torch.tensor([0.9, 0.1, 0.2, 0.3, 0.4])
    torch.testing.assert_close(ops.sa_update(x, buf, x, c),
                               t_update_mod.sa_update_plain(x, buf, x, c),
                               rtol=0, atol=0)
    p, q = ops.sa_fused_update(x, buf, x, torch.stack([c, c]))
    torch.testing.assert_close(p, q, rtol=0, atol=0)
    qkv = torch.randn(1, 2, 8, 16)
    torch.testing.assert_close(
        ops.flash_attention(qkv, qkv, qkv, causal=False),
        t_flash_mod.flash_attention_plain(qkv, qkv, qkv, causal=False),
        rtol=0, atol=0)
    wkv_in = [torch.from_numpy(a) for a in
              _wkv_inputs(np.random.default_rng(1), 1, 32, 2, 16)]
    for got, want in zip(ops.wkv(*wkv_in, chunk=16),
                         t_wkv_mod.rwkv6_wkv_plain(*wkv_in, chunk=16)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert ops.launch_counts() == {"sa_update": 0, "sa_fused": 0,
                                   "flash_attention": 0, "rwkv6_wkv": 0}
    with pytest.raises(ValueError, match="mode"):
        ops.sa_update(x, buf, x, c, mode="kernel")


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers launch on a CUDA tensor or raise: a CPU tensor never
    silently takes the plain version through them."""
    x = torch.randn(16)
    buf = torch.randn(2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        t_update_mod.sa_update(x, buf, x, torch.zeros(4))
    with pytest.raises(ValueError, match="CUDA"):
        t_fused_mod.sa_fused_update(x, buf, x, torch.zeros(2, 4))
    q = torch.randn(1, 2, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        t_flash_mod.flash_attention(q, q, q)
    wkv_in = [torch.from_numpy(a) for a in
              _wkv_inputs(np.random.default_rng(1), 1, 32, 2, 16)]
    with pytest.raises(ValueError, match="CUDA"):
        t_wkv_mod.rwkv6_wkv(*wkv_in, chunk=16)
    assert ops.launch_counts()["sa_update"] == 0
    assert ops.launch_counts()["rwkv6_wkv"] == 0


# ------------------------------------------------------ combine geometry
_ITEM_DTYPES = {4: torch.float32, 2: torch.bfloat16}


def _combine_hits(n, itemsize, vectorized, blocks, threads):
    """How often the combine kernels' loops touch each of the n elements,
    with the index mapping of ``combine_geometry``'s docstring (the
    vector loop, then the scalar loop)."""
    V = 16 // itemsize
    n_vec = n // V if vectorized else 0
    first = np.arange(blocks * threads)
    idx = []
    for k in range(0, n_vec, blocks * threads):
        v = k + first
        v = v[v < n_vec]
        idx.append((v[:, None] * V + np.arange(V)).ravel())
    for k in range(n_vec * V, n, blocks * threads):
        e = k + first
        idx.append(e[e < n])
    idx = np.concatenate(idx) if idx else np.zeros(0, np.int64)
    return np.bincount(idx, minlength=n)


@pytest.mark.parametrize("n", [1, 7, 32768, 131072, 1000003, 8388608])
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("vectorized", [True, False])
def test_combine_geometry_covers_every_element_once(n, itemsize, vectorized):
    """The launch geometry on a 132-SM card: each element is combined
    exactly once; the main path's latent (n = 32,768) spans at least 64
    SMs in f32 and bf16; at large n the grid stays within its cap (the
    resident blocks on the vector path). A ragged n never takes the vector
    path."""
    sms = 132
    V = 16 // itemsize
    if vectorized and n % V:
        x = torch.zeros(n, dtype=_ITEM_DTYPES[itemsize])
        args = t_update_mod.launch_args(x, x[None], x, torch.zeros(3),
                                        (x,), sms)
        assert args[-1] == 0
        assert args[-3:-1] == t_update_mod.combine_geometry(n, itemsize,
                                                            False, sms)
        return
    blocks, threads = t_update_mod.combine_geometry(n, itemsize, vectorized,
                                                    sms)
    assert blocks >= 1 and threads in (32, 64, 128, 256)
    hits = _combine_hits(n, itemsize, vectorized, blocks, threads)
    assert hits.min() == 1 and hits.max() == 1
    if n == 32768:
        assert blocks >= 64
    items = n // V if vectorized else n
    if items > sms * t_update_mod.BLOCK:
        assert threads == t_update_mod.BLOCK
        assert blocks <= sms * (t_update_mod.RESIDENT_BLOCKS if vectorized
                                else t_update_mod.SCALAR_BLOCKS)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype,offset", [(torch.float32, 0),
                                          (torch.bfloat16, 0),
                                          (torch.float32, 1)])
def test_combine_launch_args_match_c_signatures(fused, dtype, offset):
    """The wrappers' arguments, one lane and the stream, fit the C entry
    points' ctypes signatures in ``_build.SIGNATURES`` (count and integer
    widths), end with the geometry of ``combine_geometry``, and ask for
    the vector path only on 16-byte aligned operands."""
    from repro_torch.kernels import _build
    P, n = 3, 4096
    view = lambda s: torch.randn(math.prod(s) + offset).to(dtype)[offset:] \
        .view(s)
    x, buf, xi = view((n,)), view((P, n)), view((n,))
    coeffs = torch.randn(2, P + 2) if fused else torch.randn(P + 2)
    outs = (torch.empty_like(x),) * (2 if fused else 1)
    args = t_update_mod.launch_args(x, buf, xi, coeffs, outs, 132) + (1, 0)
    name = "sa_fused_launch" if fused else "sa_update_launch"
    sig = _build.SIGNATURES["sa_combine"][name]
    assert len(args) == len(sig)
    for ctype, value in zip(sig, args):
        assert isinstance(value, int) and not isinstance(value, bool)
        bits = 8 * ctypes.sizeof(ctype)
        lo = 0 if ctype is ctypes.c_void_p else -2 ** (bits - 1)
        assert lo <= value < lo + 2 ** bits, (ctype, value)
    vectorized = offset == 0
    assert args[-3] == int(vectorized)
    assert args[-5:-3] == t_update_mod.combine_geometry(
        n, x.element_size(), vectorized, 132)
    assert args[-8:-5] == (n, P, t_update_mod.DTYPE_CODES[dtype])


# ----------------------------------------------------------- card only
def _combine_card_inputs(card, shape, P, dtype, offset=0):
    """x, buf, xi in ``dtype`` and coeffs [2, P+2], each a contiguous view
    ``offset`` elements into its storage (off 16-byte alignment for an odd
    offset: the kernels' scalar path)."""
    g = torch.Generator(card).manual_seed(P)

    def rnd(s):
        flat = torch.randn(math.prod(s) + offset, generator=g, device=card)
        return flat.to(dtype)[offset:].view(s)
    x, buf, xi = rnd(shape), rnd((P,) + shape), rnd(shape)
    c = torch.zeros(2 * (P + 2) + offset, device=card)[offset:].view(2, P + 2)
    c.copy_(torch.tensor([[0.9, 0.1] + [0.3 / (j + 1) for j in range(P)],
                          [0.9, 0.1] + [-0.2 * (j + 1) for j in range(P)]]))
    return x, buf, xi, c


def _check_combines_on_card(x, buf, xi, c):
    before = ops.launch_counts()
    outs = [(ops.sa_update(x, buf, xi, c[0]),
             ops.sa_update(x, buf, xi, c[0], mode="plain")),
            *zip(ops.sa_fused_update(x, buf, xi, c),
                 ops.sa_fused_update(x, buf, xi, c, mode="plain"))]
    after = ops.launch_counts()
    assert after["sa_update"] - before["sa_update"] == 1
    assert after["sa_fused"] - before["sa_fused"] == 1
    for got, ref in outs:
        assert_close(got.cpu().float().numpy(), ref.cpu().float().numpy(),
                     str(x.dtype).replace("torch.", ""))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 256, 16), (1000003,), (4, 100, 7),
                                   (8388608,)])
@pytest.mark.parametrize("P", [1, 3, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_combine_kernels_match_plain_on_card(card, shape, P, dtype):
    _check_combines_on_card(*_combine_card_inputs(card, shape, P, dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("P", [1, 3, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_combine_kernels_take_offset_views_on_card(card, P, dtype):
    """The main path's n as views one element into their storage: the
    vector path cannot take them, the scalar path must."""
    x, buf, xi, c = _combine_card_inputs(card, (32768,), P, dtype, offset=1)
    assert x.data_ptr() % 16 and t_update_mod.launch_args(
        x, buf, xi, c, (x,), 132)[-1] == 0
    _check_combines_on_card(x, buf, xi, c)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 256, 16), (8388608,)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_combine_kernels_repeat_bitwise_on_card(card, shape, dtype):
    """Ten calls of each combine on the same inputs give the same bits."""
    x, buf, xi, c = _combine_card_inputs(card, shape, 3, dtype)
    first = (ops.sa_update(x, buf, xi, c[0]), *ops.sa_fused_update(x, buf, xi, c))
    for _ in range(9):
        again = (ops.sa_update(x, buf, xi, c[0]),
                 *ops.sa_fused_update(x, buf, xi, c))
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def _launch_combine(x, buf, xi, coeffs, geometry=None, vectorized=None,
                    lanes=1):
    """Launch a combine through its C entry point (sa_fused for coeffs
    [2, P+2]) with the wrapper's arguments for one lane, the geometry, the
    vector flag or the lane count replaced where given. Returns (rc,
    outputs)."""
    from repro_torch.kernels import _build
    outs = tuple(torch.empty_like(x) for _ in range(coeffs.dim()))
    args = list(t_update_mod.launch_args(x, buf, xi, coeffs, outs, 132))
    if geometry is not None:
        args[-3:-1] = geometry
    if vectorized is not None:
        args[-1] = vectorized
    lib = _build.load("sa_combine")
    fn = lib.sa_fused_launch if coeffs.dim() == 2 else lib.sa_update_launch
    rc = fn(*args, lanes, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    return rc, outs


@pytest.mark.gpu
@pytest.mark.parametrize("shape,offset", [((8, 256, 16), 0), ((131072,), 0),
                                          ((5003,), 0), ((32768,), 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_combine_kernels_same_bits_at_any_geometry_on_card(card, shape,
                                                           offset, dtype):
    """The geometry moves work between threads and steps, never the
    arithmetic: every geometry the kernels run gives the wrapper's bits,
    grid-stride loops and partial last steps included."""
    x, buf, xi, c = _combine_card_inputs(card, shape, 3, dtype, offset)
    geometries = [(1, 32), (3, 64), (7, 256), (500, 128), (264, 256),
                  (2112, 256)]
    for coeffs in (c[0], c):
        rc, want = _launch_combine(x, buf, xi, coeffs)
        assert rc == 0
        for geometry in geometries:
            rc, got = _launch_combine(x, buf, xi, coeffs, geometry)
            assert rc == 0, geometry
            assert all(torch.equal(a, b) for a, b in zip(got, want)), geometry


@pytest.mark.gpu
def test_combine_kernels_refuse_a_geometry_they_cannot_run(card):
    """The C entry points return an error and launch nothing for a block
    size or grid they have no instance for, a lane count outside
    1..65535, the vector path on unaligned operands or a vector flag other
    than 0 and 1, or no history row (P < 1)."""
    x, buf, xi, c = _combine_card_inputs(card, (4096,), 3, torch.float32)
    xo, bo, xio, co = _combine_card_inputs(card, (4096,), 3, torch.float32,
                                           offset=1)
    for coeffs in (c[0], c):
        assert _launch_combine(x, buf, xi, coeffs)[0] == 0
        for geometry in ((4, 48), (4, 512), (0, 64)):
            assert _launch_combine(x, buf, xi, coeffs, geometry)[0] != 0
        assert _launch_combine(x, buf, xi, coeffs, vectorized=2)[0] != 0
        for lanes in (0, 65536):
            assert _launch_combine(x, buf, xi, coeffs, lanes=lanes)[0] != 0
    assert _launch_combine(xo, bo, xio, co[0], vectorized=1)[0] != 0
    with pytest.raises(ValueError, match="history rows"):
        ops.sa_update(x, torch.zeros(0, 4096, device=card), xi,
                      torch.zeros(2, device=card))
    empty = torch.zeros(0, 4096, device=card)
    for coeffs in (c[0, :2].contiguous(), c[:, :2].contiguous()):
        assert _launch_combine(x, empty, xi, coeffs)[0] != 0


@pytest.mark.gpu
@pytest.mark.parametrize("shape,offset", [((8, 256, 16), 0), ((32768,), 1),
                                          ((4, 100, 7), 0)])
@pytest.mark.parametrize("P", [6, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_combine_kernels_past_five_rows_equal_plain_on_card(card, shape,
                                                            offset, P, dtype):
    """The runtime-P kernel (P >= 6) keeps the plain chain's order and
    rounding: both entries, solo and over 8 lanes, on the vector and the
    scalar path, bit for bit."""
    x, buf, xi, c = _combine_card_inputs(card, shape, P, dtype, offset)
    outs = [(ops.sa_update(x, buf, xi, c[0]),
             ops.sa_update(x, buf, xi, c[0], mode="plain")),
            *zip(ops.sa_fused_update(x, buf, xi, c),
                 ops.sa_fused_update(x, buf, xi, c, mode="plain"))]
    L = 8
    lx, lb, lxi = (torch.stack([t * (1 + 0.1 * l) for l in range(L)])
                   for t in (x, buf, xi))
    lc = torch.stack([c * (1 + 0.1 * l) for l in range(L)]).contiguous()
    lc0 = lc[:, 0].contiguous()
    outs += [(ops.sa_update_lanes(lx, lb, lxi, lc0),
              ops.sa_update_lanes(lx, lb, lxi, lc0, mode="plain")),
             *zip(ops.sa_fused_update_lanes(lx, lb, lxi, lc),
                  ops.sa_fused_update_lanes(lx, lb, lxi, lc, mode="plain"))]
    torch.cuda.synchronize()
    assert all(torch.equal(got, ref) for got, ref in outs)


#: (B, H, K, S = T, hd, causal) for the kernel on the card: the main path's
#: shape, every head dim with a kernel instance, lengths at the edges of the
#: kernel's 64-key tiles and 128-row query tiles (64 rows for hd > 80) under
#: both masks, GQA 4:1; at hd 256 and 224 (32-key tiles) the edges of their
#: tiles, GQA 4:1, gemma-7b's heads at a prompt of 512 and zamba2-7b's at
#: 256
FLASH_CARD_CASES = [
    (8, 16, 16, 256, 72, False), (2, 16, 4, 256, 72, True),
    (2, 4, 4, 257, 72, False), (2, 4, 2, 200, 64, True),
    (2, 4, 2, 130, 128, False),
    *[(2, 4, 2, 96, hd, True) for hd in t_flash_mod.HEAD_DIMS],
    *[(2, 4, 4, n, 72, causal) for n in (1, 63, 64, 65, 127, 128, 129)
      for causal in (False, True)],
    (2, 8, 2, 129, 72, False),
    *[(2, 4, 4, n, 256, causal) for n in (1, 31, 32, 33, 63, 64, 65)
      for causal in (False, True)],
    (2, 8, 2, 129, 256, False), (1, 16, 16, 512, 256, True),
    # hd 224 (zamba2-7b's shared attention): the same edges, GQA 4:1, its
    # heads at the denoiser's 256 positions
    *[(2, 4, 4, n, 224, causal) for n in (1, 31, 32, 33, 63, 64, 65)
      for causal in (False, True)],
    (2, 8, 2, 129, 224, False), (1, 32, 32, 256, 224, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,K,S,hd,causal", FLASH_CARD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_on_card(card, B, H, K, S, hd, causal,
                                            dtype):
    g = torch.Generator(card).manual_seed(S)
    rnd = lambda s: torch.randn(s, generator=g, device=card).to(dtype)
    q, k, v = rnd((B, H, S, hd)), rnd((B, K, S, hd)), rnd((B, K, S, hd))
    got = ops.flash_attention(q, k, v, causal=causal)
    ref = ops.flash_attention(q, k, v, causal=causal, mode="plain")
    assert_close(got.cpu().float().numpy(), ref.cpu().float().numpy(),
                 str(dtype).replace("torch.", ""), 2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [8, 20, 33, 40, 100, 136, 200, 250])
@pytest.mark.parametrize("S", [1, 31, 33, 65, 129])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_any_head_dim_on_card(card, hd, S, causal, dtype):
    """Head dims without an instance of their own, through the smallest
    instance that holds them (rows hd long, hd..HD-1 zero in the tiles,
    only hd columns written): GQA 4:1, lengths at the key tiles' edges."""
    g = torch.Generator(card).manual_seed(hd + S)
    rnd = lambda s: torch.randn(s, generator=g, device=card).to(dtype)
    q, k, v = rnd((2, 8, S, hd)), rnd((2, 2, S, hd)), rnd((2, 2, S, hd))
    got = ops.flash_attention(q, k, v, causal=causal)
    ref = ops.flash_attention(q, k, v, causal=causal, mode="plain")
    assert_close(got.cpu().float().numpy(), ref.cpu().float().numpy(),
                 str(dtype).replace("torch.", ""), 2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("hd,wide", [(64, 72), (224, 256)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_wider_instance_gives_the_same_bits_on_card(card, hd, wide,
                                                          causal, dtype):
    """A head dim through a wider instance with the same key tile and
    m-tiles gives its own instance's bits: the zero columns add exact
    zeros."""
    g = torch.Generator(card).manual_seed(hd)
    rnd = lambda s: torch.randn(s, generator=g, device=card).to(dtype)
    q, k, v = rnd((2, 8, 129, hd)), rnd((2, 2, 129, hd)), rnd((2, 2, 129, hd))
    own = t_flash_mod.flash_attention(q, k, v, causal=causal)
    through = t_flash_mod.flash_attention(q, k, v, causal=causal,
                                          instance=wide)
    assert torch.equal(own, through)
    with pytest.raises(ValueError, match="cannot run head dim"):
        t_flash_mod.flash_attention(q, k, v, causal=causal, instance=hd - 8)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_takes_unaligned_tensors(card, dtype):
    """Contiguous q/k/v whose storage starts one element past a 16-byte
    boundary take the kernel's element-wise tile loads."""
    g = torch.Generator(card).manual_seed(9)
    shape = (1, 4, 70, 72)
    n = int(np.prod(shape))
    q, k, v = (torch.randn(n + 1, generator=g, device=card).to(dtype)[1:]
               .view(shape) for _ in range(3))
    assert q.data_ptr() % 16 and q.is_contiguous()
    for causal in (False, True):
        got = ops.flash_attention(q, k, v, causal=causal)
        ref = ops.flash_attention(q, k, v, causal=causal, mode="plain")
        assert_close(got.cpu().float().numpy(), ref.cpu().float().numpy(),
                     str(dtype).replace("torch.", ""), 2e-5)


def _check_wkv_on_card(card, B, T, H, hd, chunk, dtype, logw_dtype,
                       decay_shift, floor=-8.0, seed=None):
    """One kernel call against the plain version on the same card inputs
    (drawn from ``seed``, by default T + hd): r/k/v in ``dtype``, logw =
    clip(-exp(N(0,1) - decay_shift), floor, -1e-5) in ``logw_dtype``,
    nonzero S0."""
    g = torch.Generator(card).manual_seed(T + hd if seed is None else seed)
    rnd = lambda s: torch.randn(s, generator=g, device=card)
    r, k, v = (rnd((B, T, H, hd)).to(dtype) for _ in range(3))
    logw = torch.clamp(-torch.exp(rnd((B, T, H, hd)) - decay_shift), floor,
                       -1e-5).to(logw_dtype)
    u, S0 = rnd((H, hd)), rnd((B, H, hd, hd))
    before = ops.launch_counts()["rwkv6_wkv"]
    y, S = ops.wkv(r, k, v, logw, u, S0, chunk=chunk)
    assert ops.launch_counts()["rwkv6_wkv"] == before + 1
    y_ref, S_ref = ops.wkv(r, k, v, logw, u, S0, chunk=chunk, mode="plain")
    torch.cuda.synchronize()
    assert y.dtype == S.dtype == torch.float32
    assert_scale_close(y.cpu().numpy(), y_ref.cpu().numpy(), 2e-5)
    assert_scale_close(S.cpu().numpy(), S_ref.cpu().numpy(), 2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H,hd,chunk", [
    (8, 256, 40, 64, 64),   # RWKV6-3B's denoiser path
    (2, 128, 4, 32, 64),    # the smoke config's head dim
    (2, 64, 3, 16, 16), (1, 128, 2, 32, 32), (2, 96, 2, 64, 32),
    (2, 64, 3, 64, 64),     # one chunk
    (1, 1024, 2, 64, 64),   # 16 chunks: two cluster groups of 8
    (1, 576, 2, 32, 64),    # 9 chunks: groups of 5 and 4
    (1, 160, 2, 16, 16)])   # 10 chunks of 16
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("decay_shift,floor", [
    (0.0, -8.0), (4.0, -8.0),   # 4: state carries over
    (-3.0, -50.0)])             # large decays, beyond the model's clamp
def test_wkv_kernel_matches_plain_on_card(card, B, T, H, hd, chunk, dtype,
                                          decay_shift, floor):
    _check_wkv_on_card(card, B, T, H, hd, chunk, dtype, torch.float32,
                       decay_shift, floor)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", t_wkv_mod.HEAD_DIMS)
@pytest.mark.parametrize("chunk", t_wkv_mod.CHUNKS)
@pytest.mark.parametrize("dtype,logw_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
def test_wkv_kernel_every_instance_on_card(card, hd, chunk, dtype,
                                           logw_dtype):
    """Every head dim x chunk instance, over 9 chunks (two cluster groups),
    with bfloat16 inputs too."""
    _check_wkv_on_card(card, 2, 9 * chunk, 3, hd, chunk, dtype, logw_dtype,
                       0.0, seed=9 * chunk + hd + chunk)


@pytest.mark.gpu
@pytest.mark.parametrize("hd,chunk", [(64, 64), (64, 16), (16, 16)])
def test_wkv_kernel_many_groups_repeat_bitwise_on_card(card, hd, chunk):
    """64 or 128 chunks, 8 or 16 cluster groups one after another, with
    the state carried across them (decay shift 4): ten calls on the same
    inputs agree bit for bit (the kernel has no atomics, so a difference is
    a race between one group's last product and the next group's tile
    loads) and with the plain version within 2e-5."""
    T = 128 * chunk if chunk == 16 else 64 * chunk
    g = torch.Generator(card).manual_seed(T + hd + 1)
    rnd = lambda s: torch.randn(s, generator=g, device=card)
    r, k, v = (rnd((2, T, 4, hd)) for _ in range(3))
    logw = torch.clamp(-torch.exp(rnd((2, T, 4, hd)) - 4.0), -8.0, -1e-5)
    u, S0 = rnd((4, hd)), rnd((2, 4, hd, hd))
    outs = [ops.wkv(r, k, v, logw, u, S0, chunk=chunk) for _ in range(10)]
    y_ref, S_ref = ops.wkv(r, k, v, logw, u, S0, chunk=chunk, mode="plain")
    torch.cuda.synchronize()
    for y, S in outs[1:]:
        assert torch.equal(y, outs[0][0]) and torch.equal(S, outs[0][1])
    assert_scale_close(outs[0][0].cpu().numpy(), y_ref.cpu().numpy(), 2e-5)
    assert_scale_close(outs[0][1].cpu().numpy(), S_ref.cpu().numpy(), 2e-5)


@pytest.mark.gpu
def test_wkv_kernel_refuses_what_it_has_no_instance_for(card):
    def inputs(T, hd):
        r = torch.zeros((1, T, 2, hd), device=card)
        return (r, r, r, r - 1.0, torch.zeros((2, hd), device=card),
                torch.zeros((1, 2, hd, hd), device=card))
    with pytest.raises(ValueError, match="head dim"):
        ops.wkv(*inputs(64, 8), chunk=16)
    with pytest.raises(ValueError, match="chunk"):
        ops.wkv(*inputs(64, 16), chunk=8)
    with pytest.raises(ValueError, match="chunk"):
        ops.wkv(*inputs(48, 16), chunk=32)
    with pytest.raises(TypeError, match="float32"):
        ops.wkv(*(a.half() for a in inputs(64, 16)), chunk=16)


# ------------------------------------------------ the device-side gate
def test_run_if_is_a_python_branch_on_the_cpu():
    """On the CPU ``run_if`` reads the flag and runs the body or not; the
    fire counter counts the bodies run."""
    from repro_torch.kernels import graph_gate
    graph_gate.reset_fires()
    ran = []
    for flag in (True, False, True):
        graph_gate.run_if(torch.tensor(flag), lambda: ran.append(1))
    assert ran == [1, 1] and graph_gate.fires("cpu") == 2
    graph_gate.reset_fires()
    assert graph_gate.fires("cpu") == 0


@pytest.mark.gpu
def test_run_if_conditional_node_replays_eager_on_card(card):
    """A body gated by ``run_if`` inside a captured graph (a conditional IF
    node) runs at replay exactly where its flag holds: every flag pattern
    replays its eager result bit for bit (a cuBLAS product and the flash
    kernel in the body), the fire counter counts the bodies run, and a
    replay adds only the launches outside the bodies."""
    from repro_torch.core.samplers.base import capture_graph
    from repro_torch.kernels import graph_gate
    g = torch.Generator(card).manual_seed(0)
    w = torch.randn(72, 72, generator=g, device=card) / 9
    x = torch.randn(2, 16, 256, 72, generator=g, device=card)
    out = torch.zeros_like(x)
    mask = torch.zeros(2, dtype=torch.bool, device=card)

    def fn():
        h = out * 0.5
        for k in range(3):
            def body():
                y = ops.flash_attention(h @ w, x, x, causal=False) + k
                out.copy_(torch.where(mask[:, None, None, None], y, h))
            out.copy_(h)
            graph_gate.run_if(mask.any(), body)
            h = ops.flash_attention(out, x, x, causal=False) + 1.0
        return h

    def load(m):
        out.fill_(1.0)
        mask.copy_(torch.tensor(m, device=card))

    cases = [[True, False], [False, False], [False, True], [True, True]]
    refs = []
    for m in cases:
        load(m)
        refs.append(fn().clone())
    load([False, False])
    _, graph, res, launches = capture_graph(fn, card, "the gate test")
    assert launches == {"flash_attention": 3}
    graph_gate.reset_fires()
    before = ops.launch_counts()["flash_attention"]
    for m, ref in zip(cases, refs):
        load(m)
        graph.replay()
        ops.add_launches(launches)
        assert torch.equal(res, ref), m
    assert graph_gate.fires(card) == 3 * 3
    assert ops.launch_counts()["flash_attention"] - before == 3 * 4
