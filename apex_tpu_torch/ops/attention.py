"""Flash attention: CUDA C++ forward and backward with a custom autograd.

Port of ``apex_tpu/ops/attention.py``'s ``flash_attention`` and
``flash_attention_lse`` at their public (B, Sq, H, D) layout, with their
whole function: an additive bias broadcasting against (B, H, Sq, Sk),
causal masking with an optional runtime frontier, Sq ≠ Sk, and softmax
dropout whose keep mask is the JAX package's counter-based hash, bit for
bit. Kernels replaced (sources under ``apex_tpu_torch/csrc/``):

- ``flash_wgmma_fwd_kernel`` (``flash_attn_fwd.cu``) ← ``_fwd_kernel_nl``
  (``_flash_fwd_nl``'s pallas_call) and ``_fwd_kernel`` (``_flash_fwd``,
  the (B·H, S, D) layout the JAX package takes when the heads do not group
  into 128 lanes): online-softmax attention giving o and lse (f32,
  (B·H, Sq)), with P cast to v's dtype before PV.
- ``flash_wgmma_bwd_kernel`` (``flash_attn_bwd.cu``) ←
  ``_bwd_fused_kernel_nl``, the split
  ``_bwd_dq_kernel_nl``/``_bwd_dkv_kernel_nl`` and the (B·H, S, D) pair
  ``_bwd_dq_kernel``/``_bwd_dkv_kernel``: a dk/dv kernel per k tile looping
  over q tiles and a dq kernel per q tile looping over k tiles, both
  recomputing P and the dropout mask; no atomics, so the result is
  deterministic. ``delta = Σ do·o`` (less the lse cotangent in the lse
  variant) is plain PyTorch, as the JAX package computes it in jnp.
- ``flash_generic_fwd_kernel``/``flash_generic_bwd_kernel``
  (``flash_attn_generic.cu``) ← the same JAX kernels for the operands the
  wgmma kernels refuse: f32 q, k, v, and any head dim 1 ≤ D ≤ 256 (the
  JAX kernels pad D to whole 128-lane rows and take f32), at any base
  address and row stride. Warp-level ``mma.sync`` on the tensor cores:
  m16n8k16 at 16 bits, and at f32 three m16n8k8 TF32 products a product
  (x = hi + lo, hi·hi + hi·lo + lo·hi, f32 accuracy); tiles loaded by
  ``cp.async`` (16-byte copies where the base, strides and D allow, else
  narrower), D padded only to the MMA's depth; the same options, the same
  keep mask and the same two-pass, atomic-free backward.

:func:`flash_fwd_kernel`/:func:`flash_bwd_kernel` pick one of the two
families from (dtype, D) alone (:func:`kernel_route`): bf16/fp16 at D in
{32, 64, 128} take the wgmma kernels, every other f32/bf16/fp16 call
with 1 ≤ D ≤ 256 the generic ones; nothing else launches. The CUDA kernels index
(b, h) directly, so they take any H with no second layout. The gradient of a
learned bias is dense plain PyTorch, computed only when the bias requires
grad (the JAX package's ``_bias_grad`` is jnp). Dropout block coordinates
come from the JAX package's block choice (``_choose_block``), not from the
CUDA tile.
"""

from __future__ import annotations

import ctypes
import math

import torch

from apex_tpu_torch.amp import functional_patch
from apex_tpu_torch.ops import _build, autotune
from apex_tpu_torch.ops._priced import priced

NEG_INF = -1e30
LANES = 128
DEFAULT_BLOCK_Q = 1024
DEFAULT_BLOCK_K = 1024
#: the JAX package's tile cap for bias/dropout kernels: the dropout hash is
#: a function of block coordinates, so the mask depends on this number
DROPOUT_TILE = 512

_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
#: the wgmma kernels' domain: 16-bit operands at these head dims
_WGMMA_DTYPES = (torch.bfloat16, torch.float16)
_WGMMA_HEAD_DIMS = (32, 64, 128)
#: the generic kernels' domain: any of _DTYPES at 1 <= D <= MAX_HEAD_DIM
MAX_HEAD_DIM = 256
_M32 = 0xFFFFFFFF


# --- the JAX package's choices that fix results (copies, not imports) ------

def _block_cap(block_q, block_k, has_bias, dropout_rate):
    """Tile cap of the bias/dropout kernels (``attention.py:61``)."""
    if has_bias or dropout_rate > 0.0:
        return min(block_q, DROPOUT_TILE), min(block_k, DROPOUT_TILE)
    return block_q, block_k


def _choose_block(pref, s, lane: bool = False):
    """Tile size for a sequence dim (``attention.py:79``): clamp to the
    sequence, keep it 8-aligned, halve while padding waste exceeds half a
    tile; ``lane=True`` rounds a multi-block key tile up to 128s."""
    b = -(-min(pref, max(16, s)) // 8) * 8
    while b > 128 and (-(-s // b)) * b - s > b // 2:
        b //= 2
    if lane and -(-s // b) > 1 and b % LANES:
        b = -(-b // LANES) * LANES
    return b


def _dropout_blocks(sq, sk, block_q=DEFAULT_BLOCK_Q,
                    block_k=DEFAULT_BLOCK_K):
    """(bq, bk): the JAX kernels' blocks under dropout for the caller's
    ``block_q``/``block_k``, i.e. the dropout mask's block coordinates (at
    the defaults S = 512 gives one block, S = 600 gives 128s; blocks of 128
    give 128s at S = 512)."""
    cq, ck = _block_cap(block_q, block_k, True, 1.0)
    return _choose_block(cq, sq), _choose_block(ck, sk, lane=True)


def _native_g0(nh: int, d: int):
    """Smallest head group whose g·d fills whole 128-lane rows, or None when
    the JAX package takes its (B·H, S, D) layout (``attention.py:606``)."""
    if d <= 0:
        return None
    g0 = 128 // math.gcd(d, 128)
    if nh % g0:
        return None
    return g0


def _mul32(a, c: int):
    """a·c mod 2³² for int64 a in [0, 2³²) and a constant c < 2³², without
    int64 overflow (c split into 16-bit halves)."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix_keep(seed, gb, iq, ik, rows, cols, rate):
    """The JAX package's dropout hash (``attention.py:191``): lowbias32 over
    (seed, b·H + h, q-block, k-block, row, col) in uint32 arithmetic, here in
    int64 with ``& 0xFFFFFFFF``; keep iff hash >= uint32(rate·2³²). Integer
    tensor arguments broadcast."""
    u = lambda t: torch.as_tensor(t).to(torch.int64) & _M32
    x = (u(seed) + _mul32(u(gb), 0x9E3779B9) + _mul32(u(iq), 0x85EBCA6B)
         + _mul32(u(ik), 0xC2B2AE35) + _mul32(u(rows), 0x27D4EB2F)
         + _mul32(u(cols), 0x165667B1)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x >= int(rate * 4294967296.0)


def _keep_mask_dense(seed, b, h, sq, sk, bq, bk, rate, dbo=None):
    """Bool (B·H, Sq, Sk) keep mask, bitwise what the kernels generate
    (``attention.py:1653``), on the seed's device; ``dbo`` adds the
    (q-block, k-block) offsets."""
    dev = seed.device if torch.is_tensor(seed) else torch.device("cpu")
    seed = torch.as_tensor(seed, device=dev).to(torch.int64).reshape(-1)[:1]
    gb = torch.arange(b * h, device=dev).view(-1, 1, 1)
    r = torch.arange(sq, device=dev).view(1, -1, 1)
    c = torch.arange(sk, device=dev).view(1, 1, -1)
    iq, ik = r // bq, c // bk
    if dbo is not None:
        dbo = dbo.to(device=dev, dtype=torch.int64)
        iq, ik = iq + dbo[0], ik + dbo[1]
    return _mix_keep(seed.view(1, 1, 1), gb, iq, ik, r % bq, c % bk, rate)


def _drop_scale(rate):
    """1/(1 − rate) rounded to f32, as the JAX kernels multiply by it."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))


def _seed_arr(dropout_seed, dropout_rate, device):
    if dropout_rate == 0.0:
        return None
    if not 0.0 < dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got "
                         f"{dropout_rate}")
    if dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    return torch.as_tensor(dropout_seed, device=device).to(
        torch.int32).reshape(-1)[:1]


def _off_arr(causal_offset, causal, device):
    if causal_offset is None:
        return None
    if not causal:
        raise ValueError("causal_offset requires causal=True")
    return torch.as_tensor(causal_offset, device=device).to(
        torch.int32).reshape(-1)[:1]


def _bias_mode(bias, b, h, sq, sk):
    """Validate a (B|1, H|1, Sq|1, Sk|1) bias as ``_bias_flat`` does and
    name its mode as ``_bias_group_nl`` does: 'shared', 'batch' (BERT's
    padding mask), 'head' or 'full'. The kernels read every mode through
    per-dim strides."""
    if bias.dim() != 4:
        raise ValueError(f"bias must be 4-D (B|1, H|1, Sq|1, Sk|1), got "
                         f"{tuple(bias.shape)}")
    bb, bh_ = bias.shape[0], bias.shape[1]
    if bb not in (1, b) or bh_ not in (1, h):
        raise ValueError(f"bias dims {tuple(bias.shape[:2])} must broadcast "
                         f"against (B={b}, H={h})")
    if bias.shape[2] not in (1, sq) or bias.shape[3] not in (1, sk):
        raise ValueError(f"bias dims {tuple(bias.shape[2:])} must broadcast "
                         f"against (Sq={sq}, Sk={sk})")
    return {(True, True): "shared", (False, True): "batch",
            (True, False): "head", (False, False): "full"}[(bb == 1, bh_ == 1)]


# --- the CUDA kernels --------------------------------------------------------

class _FlashArgs(ctypes.Structure):
    """``FlashArgs`` of ``csrc/flash_common.cuh``, field for field."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "q", "k", "v", "o", "dout", "dq", "dk", "dv", "lse", "delta",
            "bias", "seed", "dbo", "causal_off")]
        + [(n, ctypes.c_longlong) for n in (
            "q_bs", "q_rs", "k_bs", "k_rs", "v_bs", "v_rs", "o_bs", "o_rs",
            "do_bs", "do_rs", "dq_bs", "dq_rs", "dkv_bs", "dkv_rs",
            "bias_sb", "bias_sh", "bias_sq", "bias_sk")]
        + [(n, ctypes.c_int) for n in (
            "B", "H", "Sq", "Sk", "causal", "off_static", "drop_bq",
            "drop_bk")]
        + [("keep_threshold", ctypes.c_uint), ("drop_scale", ctypes.c_float),
           ("scale", ctypes.c_float)])


def kernel_route(dtype, d: int) -> str:
    """The flash kernel family a CUDA call with q of ``dtype`` and head
    dim ``d`` launches: ``"wgmma"`` for bf16/fp16 at D in {32, 64, 128},
    ``"generic"`` for any other f32/bf16/fp16 call with 1 <= D <= 256.
    Raises ValueError outside both domains."""
    if dtype in _WGMMA_DTYPES and d in _WGMMA_HEAD_DIMS:
        return "wgmma"
    if dtype in _DTYPES and 1 <= d <= MAX_HEAD_DIM:
        return "generic"
    raise ValueError(f"flash kernels take f32/bf16/fp16 q, k, v and head "
                     f"dims 1..{MAX_HEAD_DIM}; got {dtype}, D = {d}")


def _check_kernel_operands(q, k, v):
    """Shapes, dtypes and layout a flash kernel takes; returns its route."""
    _check_shapes(q, k, v)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash kernels take q, k, v of one dtype; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, sq, h, d = q.shape
    route = kernel_route(q.dtype, d)
    if b * h >= 65536 or sq == 0 or k.shape[1] == 0:
        raise ValueError("flash kernels take B·H < 65536 and Sq, Sk > 0")
    for t in (q, k, v):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("q, k, v must share one CUDA device")
        # rows of each head are D contiguous elements; the wgmma kernels'
        # TMA loads also want them 16-byte aligned
        if t.stride(3) != 1 or t.stride(2) != d:
            raise ValueError("flash kernels take (B, S, H, D) tensors whose "
                             "head rows are contiguous")
        if route == "wgmma" and (t.stride(1) % 8 or t.stride(0) % 8
                                 or t.data_ptr() % 16):
            raise ValueError("the wgmma flash kernels take head rows that "
                             "are 16-byte aligned")
    return route


def _device_int32(t, n, what, device):
    if (not torch.is_tensor(t) or t.dtype != torch.int32 or t.device != device
            or t.numel() < n or not t.is_contiguous()):
        raise ValueError(f"{what} must be a contiguous int32 tensor of {n} "
                         f"element(s) on {device}")
    return t.data_ptr()


def _kernel_args(q, k, v, scale, bias=None, causal=False, causal_off=None,
                 seed=None, rate=0.0, dbo=None,
                 blocks=(DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K)):
    """(_FlashArgs, tensors the launch reads, route) for q, k, v and the
    options; ``blocks`` are the caller's (block_q, block_k)."""
    route = _check_kernel_operands(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    a = _FlashArgs(q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
                   q_bs=q.stride(0), q_rs=q.stride(1), k_bs=k.stride(0),
                   k_rs=k.stride(1), v_bs=v.stride(0), v_rs=v.stride(1),
                   B=b, H=h, Sq=sq, Sk=sk, scale=scale)
    held = []
    if bias is not None:
        _bias_mode(bias, b, h, sq, sk)
        if bias.device != q.device:
            raise ValueError("bias must be on q's device")
        be = bias.float().expand(b, h, sq, sk)   # stride 0 on broadcast dims
        held.append(be)
        a.bias = be.data_ptr()
        a.bias_sb, a.bias_sh, a.bias_sq, a.bias_sk = be.stride()
    if causal:
        a.causal = 1
        if causal_off is not None:
            a.causal_off = _device_int32(causal_off, 1, "causal_off",
                                         q.device)
        else:
            a.off_static = sk - sq
    if rate > 0.0:
        a.seed = _device_int32(seed, 1, "the dropout seed", q.device)
        a.keep_threshold = int(rate * 4294967296.0)
        a.drop_scale = _drop_scale(rate)
        a.drop_bq, a.drop_bk = _dropout_blocks(sq, sk, *blocks)
        if dbo is not None:
            a.dbo = _device_int32(dbo, 2, "dropout_block_offset", q.device)
    return a, held, route


def _lib(name, entry=None):
    """The C entry point ``apex_<entry or name>(dtype, D, FlashArgs*,
    stream)`` of the library built from ``csrc/<name>.cu``."""
    fn = getattr(_build.load(name), f"apex_{entry or name}")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(_FlashArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


_GENERIC = "flash_attn_generic"


def _args_for(lib, q, k, v, scale, opts):
    """_kernel_args for the library ``lib``: the wgmma ones take only their
    domain, the generic one every call :func:`kernel_route` accepts."""
    a, held, route = _kernel_args(q, k, v, scale, **opts)
    if route != "wgmma" and lib != _GENERIC:
        raise ValueError(f"the wgmma flash kernels take bf16/fp16 at head "
                         f"dims {_WGMMA_HEAD_DIMS}")
    return a, held


def _launch_fwd(lib, q, k, v, scale, opts):
    a, _held = _args_for(lib, q, k, v, scale, opts)
    b, sq, h, d = q.shape
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    a.o, a.lse, a.o_bs, a.o_rs = (o.data_ptr(), lse.data_ptr(), o.stride(0),
                                  o.stride(1))
    entry = f"{lib}_fwd" if lib == _GENERIC else lib
    _build.check(_lib(lib, entry)(_DTYPES[q.dtype], d, ctypes.byref(a),
                                  _build.stream_ptr(q)), entry)
    return o, lse


def _launch_bwd(lib, q, k, v, do, lse, delta, scale, opts):
    a, _held = _args_for(lib, q, k, v, scale, opts)
    b, sq, h, d = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or not do.is_contiguous():
        raise ValueError("do must be a contiguous tensor like q")
    for t in (lse, delta):
        if (t.dtype != torch.float32 or t.shape != (b * h, sq)
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError("lse/delta must be contiguous f32 (B·H, Sq)")
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk, dv = (torch.empty(k.shape, dtype=q.dtype, device=q.device)
              for _ in range(2))
    a.dout, a.lse, a.delta = do.data_ptr(), lse.data_ptr(), delta.data_ptr()
    a.dq, a.dk, a.dv = dq.data_ptr(), dk.data_ptr(), dv.data_ptr()
    a.do_bs, a.do_rs = do.stride(0), do.stride(1)
    a.dq_bs, a.dq_rs = dq.stride(0), dq.stride(1)
    a.dkv_bs, a.dkv_rs = dk.stride(0), dk.stride(1)
    entry = f"{lib}_bwd" if lib == _GENERIC else lib
    _build.check(_lib(lib, entry)(_DTYPES[q.dtype], d, ctypes.byref(a),
                                  _build.stream_ptr(q)), entry)
    return dq, dk, dv


def _opts(bias, causal, causal_off, seed, rate, dbo, blocks):
    return dict(bias=bias, causal=causal, causal_off=causal_off, seed=seed,
                rate=rate, dbo=dbo, blocks=blocks)


@priced("flash_attn_fwd")
def flash_wgmma_fwd_kernel(q, k, v, scale, bias=None, causal=False,
                           causal_off=None, seed=None, rate=0.0, dbo=None,
                           blocks=(DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K)):
    """The wgmma forward (``flash_attn_fwd.cu``): bf16/fp16, D in {32, 64,
    128}; :func:`flash_fwd_kernel`'s arguments and results."""
    out = _launch_fwd("flash_attn_fwd", q, k, v, scale, _opts(
        bias, causal, causal_off, seed, rate, dbo, blocks))
    flash_wgmma_fwd_kernel.launches += 1
    return out


flash_wgmma_fwd_kernel.launches = 0


@priced("flash_attn_bwd")
def flash_wgmma_bwd_kernel(q, k, v, do, lse, delta, scale, bias=None,
                           causal=False, causal_off=None, seed=None,
                           rate=0.0, dbo=None,
                           blocks=(DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K)):
    """The wgmma backward (``flash_attn_bwd.cu``: dk/dv kernel, then dq)."""
    out = _launch_bwd("flash_attn_bwd", q, k, v, do, lse, delta, scale,
                      _opts(bias, causal, causal_off, seed, rate, dbo,
                            blocks))
    flash_wgmma_bwd_kernel.launches += 1
    return out


flash_wgmma_bwd_kernel.launches = 0


@priced("flash_generic_fwd")
def flash_generic_fwd_kernel(q, k, v, scale, bias=None, causal=False,
                             causal_off=None, seed=None, rate=0.0, dbo=None,
                             blocks=(DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K)):
    """The generic forward (``flash_attn_generic.cu``): f32/bf16/fp16 at
    any 1 <= D <= 256; :func:`flash_fwd_kernel`'s arguments and results."""
    out = _launch_fwd(_GENERIC, q, k, v, scale, _opts(
        bias, causal, causal_off, seed, rate, dbo, blocks))
    flash_generic_fwd_kernel.launches += 1
    return out


flash_generic_fwd_kernel.launches = 0


@priced("flash_generic_bwd")
def flash_generic_bwd_kernel(q, k, v, do, lse, delta, scale, bias=None,
                             causal=False, causal_off=None, seed=None,
                             rate=0.0, dbo=None,
                             blocks=(DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K)):
    """The generic backward (``flash_attn_generic.cu``: dk/dv kernel, then
    dq)."""
    out = _launch_bwd(_GENERIC, q, k, v, do, lse, delta, scale,
                      _opts(bias, causal, causal_off, seed, rate, dbo,
                            blocks))
    flash_generic_bwd_kernel.launches += 1
    return out


flash_generic_bwd_kernel.launches = 0


def flash_fwd_kernel(q, k, v, scale, bias=None, causal=False,
                     causal_off=None, seed=None, rate=0.0, dbo=None,
                     blocks=(DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K)):
    """CUDA forward: (o (B, Sq, H, D) in q's dtype, lse f32 (B·H, Sq)),
    through the family :func:`kernel_route` picks.

    ``bias`` broadcasts against (B, H, Sq, Sk); ``causal`` masks keys past
    ``row + off`` with ``off`` read from the int32 device tensor
    ``causal_off`` or Sk − Sq; ``rate > 0`` applies softmax dropout seeded
    by the int32 device tensor ``seed``, shifted by the (2,) int32 block
    offsets ``dbo``, in the dropout blocks that the caller's ``blocks``
    (block_q, block_k) realize."""
    _check_shapes(q, k, v)
    fn = (flash_wgmma_fwd_kernel if kernel_route(q.dtype, q.shape[3])
          == "wgmma" else flash_generic_fwd_kernel)
    return fn(q, k, v, scale, bias=bias, causal=causal,
              causal_off=causal_off, seed=seed, rate=rate, dbo=dbo,
              blocks=blocks)


def flash_bwd_kernel(q, k, v, do, lse, delta, scale, bias=None,
                     causal=False, causal_off=None, seed=None, rate=0.0,
                     dbo=None, blocks=(DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K)):
    """CUDA backward: (dq, dk, dv), with the forward's options, through
    the family :func:`kernel_route` picks."""
    _check_shapes(q, k, v)
    fn = (flash_wgmma_bwd_kernel if kernel_route(q.dtype, q.shape[3])
          == "wgmma" else flash_generic_bwd_kernel)
    return fn(q, k, v, do, lse, delta, scale, bias=bias, causal=causal,
              causal_off=causal_off, seed=seed, rate=rate, dbo=dbo,
              blocks=blocks)


# --- plain versions (the kernels' arithmetic, in PyTorch) --------------------

def _scores(q, k, scale, bias, causal, causal_off):
    """f32 (B, H, Sq, Sk) scores, scaled and biased, and the causal validity
    mask (or None)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if not causal:
        return s, None
    sq, sk = s.shape[-2:]
    off = (sk - sq if causal_off is None
           else causal_off.to(device=s.device, dtype=torch.int64).view(()))
    rows = torch.arange(sq, device=s.device).view(-1, 1)
    return s, rows + off >= torch.arange(sk, device=s.device).view(1, -1)


def _keep(q, k, seed, rate, dbo, blocks):
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    return _keep_mask_dense(seed, b, h, sq, sk,
                            *_dropout_blocks(sq, sk, *blocks), rate,
                            dbo).view(b, h, sq, sk)


# the plain versions run with the O1 functional patch suspended: the JAX
# package's flash kernels reach no patched entry point
@functional_patch.unpatched
@priced("flash_attn_fwd")
def flash_fwd_plain(q, k, v, scale, bias=None, causal=False, causal_off=None,
                    seed=None, rate=0.0, dbo=None,
                    blocks=(DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K)):
    b, sq, h, _ = q.shape
    s, valid = _scores(q, k, scale, bias, causal, causal_off)
    if valid is not None:
        s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if valid is not None:
        # a row with no key: p = 0, so l = 0, o = 0 and lse = NEG_INF
        p = torch.where(valid, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    if rate > 0.0:      # l sums the undropped p; only PV sees the mask
        p = torch.where(_keep(q, k, seed, rate, dbo, blocks),
                        p * _drop_scale(rate), 0.0)
    safe_l = torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(),
                     v.float()) / safe_l
    lse = (m + torch.log(safe_l)).reshape(b * h, sq)
    return o.transpose(1, 2).to(q.dtype), lse


@functional_patch.unpatched
@priced("flash_attn_bwd")
def flash_bwd_plain(q, k, v, do, lse, delta, scale, bias=None, causal=False,
                    causal_off=None, seed=None, rate=0.0, dbo=None,
                    blocks=(DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K)):
    b, sq, h, _ = q.shape
    q32, k32 = q.float(), k.float()
    s, valid = _scores(q, k, scale, bias, causal, causal_off)
    p = torch.exp(s - lse.reshape(b, h, sq, 1))
    if valid is not None:
        p = torch.where(valid, p, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    pv = p
    if rate > 0.0:
        keep, inv = _keep(q, k, seed, rate, dbo, blocks), _drop_scale(rate)
        pv = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    ds = (p * (dp - delta.reshape(b, h, sq, 1))).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k32) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q32) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", pv.to(do.dtype).float(), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bias_grad(q, k, v, bias, o, lse, do, delta, scale, causal, seed, rate,
               blocks):
    """Cotangent of a learned bias (``attention.py:1665``), dense: ds = p·(dp̃
    − delta) summed over the bias's broadcast dims. ``delta`` (B·H, Sq)
    already holds any lse-cotangent shift."""
    b, sq, h, _ = q.shape
    s, valid = _scores(q, k, scale, bias, causal, None)
    p = torch.exp(s - lse.reshape(b, h, sq, 1))
    if valid is not None:
        p = torch.where(valid, p, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    if rate > 0.0:
        dp = torch.where(_keep(q, k, seed, rate, None, blocks),
                         dp * _drop_scale(rate), 0.0)
    ds = p * (dp - delta.reshape(b, h, sq, 1))
    for axis in range(4):
        if bias.shape[axis] == 1:
            ds = ds.sum(dim=axis, keepdim=True)
    return ds.to(bias.dtype)


class _FlashFn(torch.autograd.Function):
    """(o, lse (B, H, Sq)); the backward folds an lse cotangent into delta."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, causal, causal_off, seed, rate,
                dbo, blocks):
        opts = dict(bias=bias, causal=causal, causal_off=causal_off,
                    seed=seed, rate=rate, dbo=dbo, blocks=blocks)
        fwd = flash_fwd_kernel if q.is_cuda else flash_fwd_plain
        o, lse = fwd(q, k, v, scale, **opts)
        b, sq, h, _ = q.shape
        lse = lse.view(b, h, sq)
        ctx.save_for_backward(q, k, v, o, lse, bias, causal_off, seed, dbo)
        ctx.scale, ctx.causal, ctx.rate = scale, causal, rate
        ctx.blocks = blocks
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse, bias, causal_off, seed, dbo = ctx.saved_tensors
        b, sq, h, _ = q.shape
        do = torch.zeros_like(o) if do is None else do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)          # (B, Sq, H)
        delta = delta.transpose(1, 2).reshape(b * h, sq)
        if dlse is not None:
            delta = delta - dlse.reshape(b * h, sq).float()
        delta = delta.contiguous()
        lse = lse.reshape(b * h, sq)
        bwd = flash_bwd_kernel if q.is_cuda else flash_bwd_plain
        dq, dk, dv = bwd(q, k, v, do, lse, delta, ctx.scale, bias=bias,
                         causal=ctx.causal, causal_off=causal_off, seed=seed,
                         rate=ctx.rate, dbo=dbo, blocks=ctx.blocks)
        dbias = None
        if ctx.needs_input_grad[3]:
            dbias = _bias_grad(q, k, v, bias, o, lse, do, delta, ctx.scale,
                               ctx.causal, seed, ctx.rate, ctx.blocks)
        return dq, dk, dv, dbias, None, None, None, None, None, None, None


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"attention takes q (B, Sq, H, D) and k, v "
                         f"(B, Sk, H, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")


def _attention(q, k, v, bias, scale, causal, block_q, block_k, dropout_rate,
               dropout_seed, causal_offset, dropout_block_offset):
    """Checks in the JAX package's order (``_flash_attention_fwd_res``),
    then (o, lse (B, H, Sq)) through the autograd function."""
    _check_shapes(q, k, v)
    block_q, block_k = autotune.tuned_qk(q, k, block_q, block_k,
                                         dropout_rate, DEFAULT_BLOCK_Q,
                                         DEFAULT_BLOCK_K)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    seed = _seed_arr(dropout_seed, dropout_rate, q.device)
    off = _off_arr(causal_offset, causal, q.device)
    if off is not None and bias is not None:
        raise ValueError("causal_offset cannot combine with a bias")
    dbo = None
    if dropout_block_offset is not None:
        if bias is not None or _native_g0(h, d) is None:
            raise ValueError("dropout_block_offset requires the "
                             "native attention path and no bias")
        cq, ck = _block_cap(block_q, block_k, False, dropout_rate)
        realized = (_choose_block(cq, sq), _choose_block(ck, sk, lane=True))
        if realized != (DROPOUT_TILE, DROPOUT_TILE):
            raise ValueError(
                f"dropout_block_offset requires {DROPOUT_TILE}-sized "
                f"kernel blocks; this geometry realizes {realized} — shard "
                f"lengths must be multiples of {DROPOUT_TILE}")
        dbo = torch.as_tensor(dropout_block_offset, device=q.device).to(
            torch.int32).reshape(2)
    if bias is not None:
        _bias_mode(bias, b, h, sq, sk)
    return _FlashFn.apply(q, k, v, bias, scale, causal, off, seed,
                          float(dropout_rate), dbo,
                          (int(block_q), int(block_k)))


def flash_attention(q, k, v, bias=None, scale=None, causal=False,
                    block_q=DEFAULT_BLOCK_Q, block_k=DEFAULT_BLOCK_K,
                    dropout_rate=0.0, dropout_seed=None, causal_offset=None):
    """Blockwise softmax attention on q (B, Sq, H, D) and k, v (B, Sk, H, D);
    returns (B, Sq, H, D) in q's dtype. The arguments and their order are
    the JAX package's.

    ``bias``: additive, (B|1, H|1, Sq|1, Sk|1), differentiable.
    ``causal``: query i attends key j iff ``i + causal_offset >= j``, with
    ``causal_offset`` an int32 (device) scalar or None for Sk − Sq.
    ``block_q``, ``block_k``: the JAX kernels' tile preferences. Under
    dropout they fix the mask's block coordinates (capped at 512, then
    ``_choose_block``), as in the JAX package; otherwise they change only
    the order of float sums there, and the CUDA kernels keep their own
    tile. A tuning-DB hit (``autotune.tuned_qk``, family ``attention``)
    replaces them, as in the JAX package, only at the defaults and never
    under dropout, so it changes no launch of the port.
    ``dropout_rate > 0``: softmax dropout seeded by the int32
    ``dropout_seed``, the JAX package's mask bit for bit.
    """
    return _attention(q, k, v, bias, scale, causal, block_q, block_k,
                      dropout_rate, dropout_seed, causal_offset, None)[0]


def flash_attention_lse(q, k, v, bias=None, scale=None, causal=False,
                        block_q=DEFAULT_BLOCK_Q, block_k=DEFAULT_BLOCK_K, *,
                        dropout_rate=0.0, dropout_seed=None,
                        causal_offset=None, dropout_block_offset=None):
    """Like :func:`flash_attention` but returns ``(out, lse)`` with lse
    (B, H, Sq) differentiable; ``dropout_block_offset`` ((2,) int32) shifts
    the dropout hash's (q-block, k-block) coordinates, so a sequence shard
    draws the single-device mask. ``block_q``/``block_k`` come by position
    after ``causal``, the rest by keyword only, as in the JAX package."""
    if dropout_rate > 0.0 and _native_g0(q.shape[2], q.shape[3]) is None:
        raise NotImplementedError(
            "flash_attention_lse dropout requires the native attention "
            "path (lane-groupable heads)")
    return _attention(q, k, v, bias, scale, causal, block_q, block_k,
                      dropout_rate, dropout_seed, causal_offset,
                      dropout_block_offset)


def attention_reference(q, k, v, bias=None, scale=None, causal=False):
    """Plain-PyTorch oracle in fp32 (the reference's ``impl='default'``),
    with the O1 functional patch suspended, as the JAX package's."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _attention_reference(q, k, v, bias, scale, causal)


@functional_patch.unpatched
def _attention_reference(q, k, v, bias, scale, causal):
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        sq, sk = s.shape[-2:]
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=s.device).tril(diagonal=sk - sq)
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)


def dropout(x, rate, generator):
    """flax ``nn.Dropout``'s arithmetic: keep each element with probability
    1 − ``rate`` and scale it by 1/(1 − ``rate``) in ``x``'s dtype, zero the
    rest. The keep draws are ``torch.rand(x.shape, generator=generator) <
    1 − rate`` on ``x``'s device (the JAX package draws them from its
    ``'dropout'`` rng stream, whose bits the port cannot reproduce)."""
    if rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs a torch.Generator when "
                         "deterministic=False")
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


def mask_softmax_dropout(scores, mask=None, dropout_rate=0.0, generator=None,
                         deterministic=True):
    """(Masked) softmax and dropout on explicit scores, the JAX package's
    ``mask_softmax_dropout`` (the reference Apex's
    ``fast_mask_softmax_dropout_func``), in plain PyTorch: the JAX function
    is jnp and reaches no kernel. ``mask`` True keeps a score (False ones
    become -1e30), the softmax runs in f32, dropout draws from the explicit
    ``generator`` (JAX's ``rng``), and the result comes back in the scores'
    dtype."""
    s = scores.float()
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if dropout_rate > 0.0 and not deterministic:
        p = dropout(p, dropout_rate, generator)
    return p.to(scores.dtype)
