"""The Mamba-2 SSD chunk-scan kernel: CUDA launch wrapper and plain version.

:func:`ssd_scan_kernel` is the port of the reference's ``ssd_scan_pallas``
(``src/repro/kernels/ssd_scan/ssd_scan.py``): it launches the hand-written
CUDA kernel :data:`SSD_SCAN` (C entry ``ssd_scan`` in
``src/repro_torch/csrc/ssd_scan.cu``), which replaces ``_ssd_kernel``.  One
CUDA block walks one (sequence, head)'s chunks in order with the float32
state in shared memory, where the TPU grid walked the chunks and kept the
state in VMEM.  With bfloat16 ``x``, ``B`` and ``C`` (the Mamba-2 prefill)
all four products of a chunk run on the tensor cores (``mma.sync`` bf16 ->
float32): the bf16 operands are exact, and every float32 operand is cut
into bf16 parts, a high part and the remainders, and multiplied part by
part.  The masked, decayed scores and the carried state, which reach only
the bf16 ``y``, take two parts (16 significant bits); the state update's
weighted x, which reaches the float32 state, takes three (float32's 24),
so that the float32 contract of :func:`plain_tol` holds even where the
state's terms cancel.  With float32 inputs the kernel runs float32 FMAs.
The launch runs inside the custom op ``repro_torch::ssd_scan``, whose fake
implementation gives a tracer the output shapes without a launch, whose
FLOP formula counts the plain chunked SSD's dots
(:func:`ssd_scan_flops`), and whose DTensor sharding rule
(:func:`register_sharding_rule`) runs it per shard of the sequences and
heads.  :data:`SSD_SCAN` carries a plain integer ``launches`` count that
the wrapper bumps where it launches the kernel, and nowhere else;
:func:`resident_blocks` asks how many blocks an SM holds at once.  The
source file's header says what the kernel computes, what bounds it on the
H100 and how its design answers that.

:func:`ssd_scan_plain` is the Pallas body in plain PyTorch: a loop over
chunks with the float32 state carried between them.  The wrapper takes it
**only** for tensors on the CPU; for a CUDA tensor it launches the kernel
or raises.

Both cast ``dt``, ``A`` and ``D`` (a few values per token and head) to
float32 before anything else, and compute in float32 from ``x``, ``B`` and
``C`` in their own type (float32 or bfloat16).  The Pallas body multiplies
``x * dt`` in the inputs' type first; with bfloat16 ``x`` and ``dt`` that
product is rounded to bfloat16 there and not here.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# the widest head the kernel's tiling covers (kMaxP in csrc/ssd_scan.cu)
_MAX_P = 64

SSD_SCAN = build.CudaKernel(
    "ssd_scan", "ssd_scan",
    # x, dt, A, B, C, D, y, state, batch, S, H, P, N, Q, bf16, stream
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "src/repro/kernels/ssd_scan/ssd_scan.py:31",
)

_DTYPES = (torch.float32, torch.bfloat16)


def prepare(x, dt, A, B, C, D, chunk: int):
    """Check the kernel's argument contract (raising) and return the
    arguments as it takes them: ``x``, ``B``, ``C`` contiguous in their
    common type, ``dt``, ``A``, ``D`` contiguous float32."""
    if x.dim() != 4 or dt.dim() != 3 or B.dim() != 3 or C.dim() != 3:
        raise ValueError(
            f"want x (b,S,H,P), dt (b,S,H), B/C (b,S,N); got"
            f" {tuple(x.shape)}, {tuple(dt.shape)}, {tuple(B.shape)},"
            f" {tuple(C.shape)}"
        )
    b, S, H, P = x.shape
    N = B.shape[-1]
    if (tuple(dt.shape) != (b, S, H) or tuple(B.shape) != (b, S, N)
            or tuple(C.shape) != (b, S, N) or tuple(A.shape) != (H,)
            or tuple(D.shape) != (H,)):
        raise ValueError(
            f"shapes disagree: x {tuple(x.shape)}, dt {tuple(dt.shape)},"
            f" A {tuple(A.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)},"
            f" D {tuple(D.shape)}"
        )
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(
            f"x, B and C must share float32 or bfloat16; got {x.dtype},"
            f" {B.dtype}, {C.dtype}"
        )
    if not 1 <= P <= _MAX_P or N < 1:
        raise ValueError(f"need 1 <= P <= {_MAX_P} and N >= 1; got P={P},"
                         f" N={N}")
    if chunk < 1 or S % chunk:
        raise ValueError(f"S={S} must be a multiple of chunk={chunk}"
                         " (ops.ssd_scan pads it)")
    devs = {t.device for t in (x, dt, A, B, C, D)}
    if len(devs) != 1:
        raise ValueError(f"arguments lie on several devices: {devs}")
    f32 = torch.float32
    return (x.contiguous(), dt.to(f32).contiguous(), A.to(f32).contiguous(),
            B.contiguous(), C.contiguous(), D.to(f32).contiguous())


def ssd_scan_kernel(x, dt, A, B, C, D, *, chunk: int = 64
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(b,S,H,P), (b,S,H), (H,), (b,S,N), (b,S,N), (H,) -> (y, state)``.

    ``S`` must be a multiple of ``chunk``.  ``y`` is ``(b,S,H,P)`` in x's
    type and ``state`` the final ``(b,H,P,N)`` float32 state.  A tensor on
    the CPU runs :func:`ssd_scan_plain`; a CUDA tensor launches the CUDA
    kernel or raises.  The call goes through the custom op
    ``repro_torch::ssd_scan`` (:func:`_ssd_scan_op`), so a tracer sees one
    node and fake or meta tensors take its shape function.
    """
    x, dt, A, B, C, D = prepare(x, dt, A, B, C, D, chunk)
    return torch.ops.repro_torch.ssd_scan(x, dt, A, B, C, D, chunk)


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=())
def _ssd_scan_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                 chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The op's real implementation, on arguments through :func:`prepare`:
    the plain version on the CPU, the launch on CUDA."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, D, chunk=chunk)
    if x.device.type != "cuda":
        raise RuntimeError(
            f"ssd_scan_kernel runs on CUDA (or the CPU plain version), not"
            f" on {x.device}"
        )
    b, S, H, P = x.shape
    y = torch.empty_like(x)
    state = torch.empty((b, H, P, B.shape[-1]), dtype=torch.float32,
                        device=x.device)
    with torch.cuda.device(x.device):
        launch(x, dt, A, B, C, D, y, state, chunk,
               stream=torch.cuda.current_stream(x.device).cuda_stream)
    return y, state


@_ssd_scan_op.register_fake
def _(x, dt, A, B, C, D, chunk):
    b, S, H, P = x.shape
    return (torch.empty_like(x),
            x.new_empty((b, H, P, B.shape[-1]), dtype=torch.float32))


def ssd_scan_flops(x_shape, B_shape, chunk: int) -> int:
    """The dot FLOPs of the plain chunked SSD (``models.ssm.ssd_chunked``)
    at ``chunk`` over ``x (b,S,H,P)`` and ``B (b,S,N)``: per chunk of ``Q``
    positions the scores ``C B^T`` (``2bQQN``), the diagonal block against
    ``x`` (``2bHQQP``), the carried state's part of ``y`` (``2bQHPN``) and
    the state update (``2bHPNQ``)."""
    b, S, H, P = x_shape
    N = B_shape[-1]
    Q = chunk
    return 2 * b * S * (Q * N + H * Q * P + 2 * H * P * N)


def _register_flop_formula() -> None:
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.ssd_scan)
    def _flops(x_shape, dt_shape, A_shape, B_shape, C_shape, D_shape, chunk,
               *args, out_shape=None, **kwargs) -> int:
        return ssd_scan_flops(x_shape, B_shape, chunk)


_register_flop_formula()


_SHARDING_REGISTERED = False


def register_sharding_rule() -> None:
    """Register the op's DTensor sharding rule (once): its outputs follow
    inputs sharded over the sequences (``x``, ``dt``, ``B``, ``C`` and
    both outputs on dim 0), over the heads when every mesh dim divides
    them (``x``, ``dt`` on dim 2, ``A``, ``D`` on dim 0, ``y`` on dim 2,
    ``state`` on dim 1), both on two mesh dims, or all replicated.
    Imports ``torch.distributed.tensor`` only when called."""
    global _SHARDING_REGISTERED
    if _SHARDING_REGISTERED:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.ssd_scan.default)
    def _rule(x, dt, A, B, C, D, chunk):
        R = Replicate()
        rules = [
            ([R, R], [R, R, R, R, R, R, None]),
            ([Shard(0), Shard(0)],
             [Shard(0), Shard(0), R, Shard(0), Shard(0), R, None]),
        ]
        mesh = x.mesh
        if all(x.shape[2] % mesh.size(m) == 0 for m in range(mesh.ndim)):
            rules.append(([Shard(2), Shard(1)],
                          [Shard(2), Shard(2), Shard(0), R, R, Shard(0),
                           None]))
        return rules

    _SHARDING_REGISTERED = True


def resident_blocks(P: int, N: int, chunk: int, dtype: torch.dtype,
                    device: torch.device) -> int:
    """Blocks of the kernel's ``dtype`` instance that one SM of ``device``
    holds at once at head width ``P``, state ``N`` and chunk ``chunk``,
    with the dynamic shared memory a launch at those sizes passes."""
    query = SSD_SCAN.lib().ssd_scan_resident_blocks
    query.restype = ctypes.c_int
    query.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = query(P, N, chunk, int(dtype == torch.bfloat16),
                   ctypes.byref(blocks))
    SSD_SCAN.check(rc, "occupancy query")
    return blocks.value


def launch(x, dt, A, B, C, D, y, state, chunk: int, *, stream: int) -> None:
    """One bare launch into preallocated ``y`` and ``state`` on ``stream``
    (arguments already through :func:`prepare`); raises if the launch is
    refused."""
    b, S, H, P = x.shape
    SSD_SCAN.call(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                  C.data_ptr(), D.data_ptr(), y.data_ptr(), state.data_ptr(),
                  b, S, H, P, B.shape[-1], chunk,
                  int(x.dtype == torch.bfloat16), stream)


# ---------------------------------------------------------------------------
# plain PyTorch version of the same algorithm
# ---------------------------------------------------------------------------


def ssd_scan_plain(x, dt, A, B, C, D, *, chunk: int = 64
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The Pallas body in plain PyTorch, on any device, batched over the
    sequences; the same arguments and results as :func:`ssd_scan_kernel`.

    Per chunk, in float32: ``cums = cumsum(dt * A)``, the decay
    ``L[q, k] = exp(cums[q] - cums[k])`` masked to ``k <= q`` before the
    exp, ``y = (L * C B^T)(dt x) + exp(cums) C h_in^T + D x`` cast to x's
    type, then ``h = exp(cums[-1]) h + B^T (exp(cums[-1] - cums) dt x)``.
    """
    b, S, H, P = x.shape
    N = B.shape[-1]
    if S % chunk:
        raise ValueError(f"S={S} must be a multiple of chunk={chunk}")
    f32 = torch.float32
    dt, A, D = dt.to(f32), A.to(f32), D.to(f32)
    above = ~torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    h = torch.zeros((b, H, P, N), dtype=f32, device=x.device)
    ys = []
    for c0 in range(0, S, chunk):
        xk = x[:, c0:c0 + chunk].to(f32)  # (b,Q,H,P)
        dtk = dt[:, c0:c0 + chunk]  # (b,Q,H)
        Bk = B[:, c0:c0 + chunk].to(f32)  # (b,Q,N)
        Ck = C[:, c0:c0 + chunk].to(f32)
        cums = torch.cumsum(dtk * A, dim=1)  # (b,Q,H)
        xb = xk * dtk[..., None]
        seg = cums[:, :, None, :] - cums[:, None, :, :]  # (b,q,k,H)
        L = torch.exp(seg.masked_fill(above[None, :, :, None], float("-inf")))
        scores = Ck @ Bk.transpose(1, 2)  # (b,q,k)
        y_diag = torch.einsum("bqkh,bkhp->bqhp", L * scores[..., None], xb)
        y_off = torch.einsum("bqn,bhpn->bqhp", Ck, h) * torch.exp(cums)[..., None]
        ys.append((y_diag + y_off + xk * D[:, None]).to(x.dtype))
        decay_out = torch.exp(cums[:, -1:, :] - cums)  # (b,Q,H)
        h = h * torch.exp(cums[:, -1])[..., None, None] + torch.einsum(
            "bqn,bqhp->bhpn", Bk, xb * decay_out[..., None])
    return torch.cat(ys, dim=1), h


def plain_tol(ref: torch.Tensor, dtype: torch.dtype) -> float:
    """Max-abs-error tolerance of the kernel's ``y`` (in ``dtype``) or
    float32 state against :func:`ssd_scan_plain`'s ``ref`` on the same
    inputs.

    Both compute in float32 from the same values and differ only in the
    order of their sums (up to ``N`` terms per score, ``Q`` per output row,
    a carried state over every chunk): 1e-4 of the output's magnitude
    covers that with margin and is far below any indexing or masking
    error.  A bfloat16 ``y`` is rounded once from float32 in both, and two
    float32 values a rounding apart can round to neighbouring bfloat16
    values, one step of an 8-bit significand: 2^-7 of the magnitude on
    top.  The magnitude has no floor: the model's states are far below 1,
    and an absolute floor would let a wrong decay of them pass."""
    scale = float(ref.abs().max())
    return (1e-4 + (2.0 ** -7 if dtype == torch.bfloat16 else 0.0)) * scale
