"""The Mamba-2 SSD chunk-scan kernel and its backward: CUDA launch wrappers
and plain versions.

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

:func:`ssd_scan_bwd_kernel` is the backward: the gradients of all six
inputs against the upstream gradients of ``y`` and the final state.  No
Pallas kernel computes it (the reference trains through the pure-jnp
``ssd_chunked``, whose gradient XLA derives); it launches the hand-written
CUDA kernel :data:`SSD_SCAN_BWD` (``src/repro_torch/csrc/ssd_scan_bwd.cu``,
whose header gives its design and bound) inside the custom op
``repro_torch::ssd_scan_bwd``, with a fake implementation, a FLOP formula
(:func:`ssd_scan_bwd_flops`) and a DTensor sharding rule beside the
forward's, so that a dry run sees it as one node.  Its plain version
:func:`ssd_scan_bwd_plain` (the kernel's algorithm, without autograd) is
what the wrapper takes for CPU tensors.

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

# Kernel D's backward (C entry ``ssd_scan_bwd`` in csrc/ssd_scan_bwd.cu).
# No Pallas kernel computes it: the reference trains through the pure-jnp
# ``ssd_chunked``, so it replaces that function's vector-Jacobian product.
SSD_SCAN_BWD = build.CudaKernel(
    "ssd_scan_bwd", "ssd_scan_bwd",
    # x, dt, A, B, C, D, gy, gstate, dx, ddt, dA, dB, dC, dD, workspace,
    # batch, S, H, P, N, Q, bf16, stream
    [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "src/repro/models/ssm.py:30",
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
    """Register the two ops' DTensor sharding rules (once).  The forward's
    outputs follow inputs sharded over the sequences (``x``, ``dt``,
    ``B``, ``C`` and both outputs on dim 0), over the heads when every
    mesh dim divides them (``x``, ``dt`` on dim 2, ``A``, ``D`` on dim 0,
    ``y`` on dim 2, ``state`` on dim 1), both on two mesh dims, or all
    replicated.  The backward's follow the same placements of its inputs
    (``gy`` as ``y``, ``gstate`` as ``state``): over the sequences every
    gradient is sharded on dim 0 but ``dA`` and ``dD``, which are partial
    sums; over the heads ``dx``, ``ddt`` on dim 2, ``dA``, ``dD`` on dim
    0, and ``dB``, ``dC`` partial sums.  Imports
    ``torch.distributed.tensor`` only when called."""
    global _SHARDING_REGISTERED
    if _SHARDING_REGISTERED:
        return
    from torch.distributed.tensor import Partial, Replicate, Shard
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

    @register_sharding(torch.ops.repro_torch.ssd_scan_bwd.default)
    def _bwd_rule(x, dt, A, B, C, D, gy, gstate, chunk):
        # outputs dx, ddt, dA, dB, dC, dD; inputs x, dt, A, B, C, D, gy,
        # gstate, chunk.  Over the sequences dA and dD are partial sums;
        # over the heads dB and dC are (B and C are shared by the heads).
        R, S0, Sum = Replicate(), Shard(0), Partial()
        rules = [
            ([R] * 6, [R] * 8 + [None]),
            ([S0, S0, Sum, S0, S0, Sum],
             [S0, S0, R, S0, S0, R, S0, S0, None]),
        ]
        mesh = x.mesh
        if all(x.shape[2] % mesh.size(m) == 0 for m in range(mesh.ndim)):
            rules.append(([Shard(2), Shard(2), S0, Sum, Sum, S0],
                          [Shard(2), Shard(2), S0, R, R, S0, Shard(2),
                           Shard(1), None]))
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
# the backward: kernel D's vector-Jacobian product
# ---------------------------------------------------------------------------


def ssd_scan_bwd_kernel(x, dt, A, B, C, D, gy, gstate, *, chunk: int = 64
                        ) -> tuple[torch.Tensor, ...]:
    """The gradients ``(dx, ddt, dA, dB, dC, dD)`` of
    :func:`ssd_scan_kernel`'s ``(y, state)`` against the upstream gradients
    ``gy`` of ``y`` (``(b,S,H,P)``) and ``gstate`` of the final state
    (``(b,H,P,N)``); either may be ``None`` (that output did not reach the
    loss).

    The arguments go through :func:`prepare` as the forward's do; ``dx``,
    ``dB`` and ``dC`` come back in x's type, ``ddt``, ``dA`` and ``dD`` in
    float32 (the types :func:`prepare` gives; the caller casts them back).
    A tensor on the CPU runs :func:`ssd_scan_bwd_plain`; a CUDA tensor
    launches the CUDA kernel :data:`SSD_SCAN_BWD` or raises.  The call goes
    through the custom op ``repro_torch::ssd_scan_bwd``.
    """
    x, dt, A, B, C, D = prepare(x, dt, A, B, C, D, chunk)
    b, S, H, P = x.shape
    N = B.shape[-1]
    gy = (torch.zeros_like(x) if gy is None
          else gy.to(device=x.device, dtype=x.dtype).contiguous())
    gstate = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
              if gstate is None else
              gstate.to(device=x.device, dtype=torch.float32).contiguous())
    if tuple(gy.shape) != (b, S, H, P) or tuple(gstate.shape) != (b, H, P, N):
        raise ValueError(f"upstream gradients {tuple(gy.shape)},"
                         f" {tuple(gstate.shape)} do not match y"
                         f" {(b, S, H, P)} and the state {(b, H, P, N)}")
    return torch.ops.repro_torch.ssd_scan_bwd(x, dt, A, B, C, D, gy, gstate,
                                              chunk)


@torch.library.custom_op("repro_torch::ssd_scan_bwd", mutates_args=())
def _ssd_scan_bwd_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                     gy: torch.Tensor, gstate: torch.Tensor, chunk: int
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor, torch.Tensor, torch.Tensor]:
    """The op's real implementation, on arguments through :func:`prepare`:
    the plain version on the CPU, the launch on CUDA."""
    if x.device.type == "cpu":
        return ssd_scan_bwd_plain(x, dt, A, B, C, D, gy, gstate, chunk=chunk)
    if x.device.type != "cuda":
        raise RuntimeError(
            f"ssd_scan_bwd_kernel runs on CUDA (or the CPU plain version),"
            f" not on {x.device}"
        )
    grads = tuple(torch.empty_like(t) for t in (x, dt, A, B, C, D))
    with torch.cuda.device(x.device):
        launch_bwd(x, dt, A, B, C, D, gy, gstate, *grads, chunk,
                   stream=torch.cuda.current_stream(x.device).cuda_stream)
    return grads


@_ssd_scan_bwd_op.register_fake
def _(x, dt, A, B, C, D, gy, gstate, chunk):
    return tuple(torch.empty_like(t) for t in (x, dt, A, B, C, D))


def ssd_scan_bwd_workspace_bytes(x_shape, B_shape, chunk: int) -> int:
    """Bytes of the workspace one backward launch over ``x (b,S,H,P)`` and
    ``B (b,S,N)`` at ``chunk`` allocates and frees before it returns: the
    layout of ``ws_layout`` in ``csrc/ssd_scan_bwd.cu``, written out here
    so that a dry run counts it without the kernel's build.  Float32
    cumulative decays, own (then entry) states and adjoints, scores and
    their head sums on tiles of 64, partial sums of dA and dD; then the
    bf16 instance's sections: partial sums of <dh, h_in> (one a warp of
    the scan, which takes two state elements a thread where N is even),
    the carried state's term (one array a
    128-column pass of N), the entry states' and exit adjoints' three bf16
    parts, the dC/dB kernels' partial sums (four head groups, in the
    float32 states' room where they fit) and, where P or N is not a
    multiple of 8, zero-padded copies of x, gy, B and C.
    :func:`launch_bwd` checks it against the C entry's size at every
    launch."""
    b, S, H, P = x_shape
    N = B_shape[-1]
    nc, qp = S // chunk, -(-chunk // 64) * 64
    groups = 4  # kBcGroups

    def align4(v):
        return -(-v // 4) * 4

    def align64(v):
        return -(-v // 64) * 64

    units, bS = b * nc * H, b * S
    n8, p8 = -(-N // 8) * 8, -(-P // 8) * 8
    vec = 2 if N % 2 == 0 else 1  # state elements a scan thread
    nhd, npass = -(-(P * N // vec) // 256) * 8, -(-n8 // 128)
    hin = align4(b * S * H)
    dh = align4(hin + units * P * N)
    sc = align4(dh + units * P * N)
    pd = sc + 2 * b * nc * qp * qp + b * nc * H
    hd = align64(pd + b * nc * H)
    car = align64(hd + units * nhd)
    parts = (3 * units * P * n8 + 1) // 2
    ph = align64(car + npass * bS * H)
    pdh = align64(ph + parts)
    end = align64(pdh + parts)
    if groups * 2 * bS * n8 > sc - hin:
        end = align64(end + groups * 2 * bS * n8)
    if P % 8 or N % 8:
        end += 2 * align64((bS * H * p8 + 1) // 2) + 2 * align64(
            (bS * n8 + 1) // 2)
    return 4 * end


def ssd_scan_bwd_flops(x_shape, B_shape, chunk: int) -> int:
    """The dot FLOPs the backward kernel runs over ``x (b,S,H,P)`` and
    ``B (b,S,N)`` at ``chunk``.  Per chunk of ``Q`` positions and its
    ``T = Q(Q+1)/2`` pairs ``k <= q``: the scores ``C B^T`` once
    (``2TN``), the head-summed score gradient against ``C`` and ``B``
    (``2 2TN``); per head the output gradient ``dy x^T`` twice (once for
    the decay's gradient, once summed over the heads), ``G^T dy`` (``3
    2TP``), and six state products of ``2QPN`` each: the chunk's own state
    and adjoint, the carried state's part of y, ``dh B``, and the state
    terms of ``dC`` and ``dB`` (the float32 instance's count; the bf16
    instance takes the carried part from dC's state term, and runs every
    float32 operand in two or three bf16 parts besides)."""
    b, S, H, P = x_shape
    N = B_shape[-1]
    Q = chunk
    T = Q * (Q + 1) // 2
    return 2 * b * (S // Q) * (3 * T * N + H * (3 * T * P + 6 * Q * P * N))


def _register_bwd_flop_formula() -> None:
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.ssd_scan_bwd)
    def _flops(x_shape, dt_shape, A_shape, B_shape, C_shape, D_shape,
               gy_shape, gstate_shape, chunk, *args, out_shape=None,
               **kwargs) -> int:
        return ssd_scan_bwd_flops(x_shape, B_shape, chunk)


_register_bwd_flop_formula()


def launch_bwd(x, dt, A, B, C, D, gy, gstate, dx, ddt, dA, dB, dC, dD,
               chunk: int, *, stream: int) -> None:
    """One bare backward launch into preallocated gradients on
    ``stream`` (arguments through :func:`prepare`, ``gy`` in x's type,
    ``gstate`` float32, both contiguous).  The float32 workspace (chunk
    sums, entry states, exit adjoints, scores and their head-summed
    gradients, partial sums; ``ssd_scan_bwd_workspace`` sizes it) is
    allocated here.  Raises if the launch is refused."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    lib = SSD_SCAN_BWD.lib()
    size = lib.ssd_scan_bwd_workspace
    size.restype = ctypes.c_size_t
    size.argtypes = [ctypes.c_int] * 6
    nbytes = size(b, S, H, P, N, chunk)
    if nbytes != ssd_scan_bwd_workspace_bytes(x.shape, B.shape, chunk):
        raise RuntimeError(
            f"the backward's workspace is {nbytes} bytes in the C entry and"
            f" {ssd_scan_bwd_workspace_bytes(x.shape, B.shape, chunk)} in"
            " ssd_scan_bwd_workspace_bytes")
    if x.dtype == torch.bfloat16:
        # TMA reads x, gy, B and C from bases on 16 bytes
        x, B, C, gy = (t if t.data_ptr() % 16 == 0 else t.clone()
                       for t in (x, B, C, gy))
    ws = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    SSD_SCAN_BWD.call(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                      B.data_ptr(), C.data_ptr(), D.data_ptr(), gy.data_ptr(),
                      gstate.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
                      dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
                      dD.data_ptr(), ws.data_ptr(), b, S, H, P, N, chunk,
                      int(x.dtype == torch.bfloat16), stream)


# ---------------------------------------------------------------------------
# plain PyTorch version of the same algorithm
# ---------------------------------------------------------------------------


def _acc_type(x: torch.Tensor) -> torch.dtype:
    """The plain versions' working type: float32, or float64 for float64
    ``x`` (which the kernels refuse), so that a test can run them as a
    float64 oracle."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def ssd_scan_plain(x, dt, A, B, C, D, *, chunk: int = 64
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The Pallas body in plain PyTorch, on any device, batched over the
    sequences; the same arguments and results as :func:`ssd_scan_kernel`.

    Per chunk, in float32: ``cums = cumsum(dt * A)``, the decay
    ``L[q, k] = exp(cums[q] - cums[k])`` masked to ``k <= q`` before the
    exp, ``y = (L * C B^T)(dt x) + exp(cums) C h_in^T + D x`` cast to x's
    type, then ``h = exp(cums[-1]) h + B^T (exp(cums[-1] - cums) dt x)``.
    float64 ``x`` computes in float64 and gives a float64 state.
    """
    b, S, H, P = x.shape
    N = B.shape[-1]
    if S % chunk:
        raise ValueError(f"S={S} must be a multiple of chunk={chunk}")
    acc = _acc_type(x)
    dt, A, D = dt.to(acc), A.to(acc), D.to(acc)
    above = ~torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    h = torch.zeros((b, H, P, N), dtype=acc, device=x.device)
    ys = []
    for c0 in range(0, S, chunk):
        xk = x[:, c0:c0 + chunk].to(acc)  # (b,Q,H,P)
        dtk = dt[:, c0:c0 + chunk]  # (b,Q,H)
        Bk = B[:, c0:c0 + chunk].to(acc)  # (b,Q,N)
        Ck = C[:, c0:c0 + chunk].to(acc)
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


def ssd_scan_bwd_plain(x, dt, A, B, C, D, gy, gstate, *, chunk: int = 64
                       ) -> tuple[torch.Tensor, ...]:
    """The backward kernel's algorithm in plain PyTorch, on any device,
    batched over the sequences, without autograd: the same arguments and
    results as :func:`ssd_scan_bwd_kernel` after :func:`prepare` (``gy``
    and ``gstate`` given, zeros for an output that did not reach the
    loss).

    Per chunk, with the forward's ``cums``, ``xb = dt x``, the scores
    ``S = C B^T``, the masked decay ``L[q, k] = exp(cums[q] - cums[k])``,
    ``G = L S``, ``w[k] = exp(cums[-1] - cums[k])``, the entry state
    ``h_in`` and the adjoint ``dh`` of the exit state:

    1. a state pass: each chunk's own state ``sum_k w[k] xb[k]^T B[k]``
       and adjoint ``sum_q exp(cums[q]) dy[q]^T C[q]``, then ``h_in``
       carried forward over the chunks and ``dh`` backward
       (``dh_in = exp(cums[-1]) dh + the chunk's own adjoint``);
    2. per chunk: ``dxb[k] = sum_q G[q, k] dy[q] + w[k] dh B[k]``,
       ``dx = dt dxb + D dy``; ``dG = dy xb^T``; the decay's gradient
       ``dcums`` from the row sums minus the column sums of ``dG G``, the
       carried term ``dy . exp(cums) C h_in^T``, the weights' terms
       ``-w[k] xb[k] . dh B[k]`` (their sum at the last position) and
       ``exp(cums[-1]) <dh, h_in>`` at the last position; ``da`` its
       reverse cumulative sum, ``ddt = x . dxb + A da``, ``dA = sum dt
       da``, ``dD = sum x dy``; and, summed over the heads first,
       ``M = sum_h dG L``: ``dC = M B + sum_h exp(cums) dy h_in``, ``dB =
       M^T C + sum_h w xb dh``.

    All in float32 (float64 for float64 ``x``, as a test's oracle);
    ``dx``, ``dB`` and ``dC`` are cast to x's type."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    if S % chunk:
        raise ValueError(f"S={S} must be a multiple of chunk={chunk}")
    Q, nc = chunk, S // chunk
    acc = _acc_type(x)
    xf = x.to(acc).reshape(b, nc, Q, H, P)
    dtf = dt.to(acc).reshape(b, nc, Q, H)
    Bf = B.to(acc).reshape(b, nc, Q, N)
    Cf = C.to(acc).reshape(b, nc, Q, N)
    dy = gy.to(acc).reshape(b, nc, Q, H, P)
    A, D = A.to(acc), D.to(acc)
    cums = torch.cumsum(dtf * A, dim=2)  # (b,nc,Q,H)
    clast = cums[:, :, -1]  # (b,nc,H)
    xb = xf * dtf[..., None]
    w = torch.exp(clast[:, :, None] - cums)
    ec = torch.exp(cums)

    # 1. the state pass: entry states forward, exit adjoints backward
    own = torch.einsum("bckhp,bckn->bchpn", xb * w[..., None], Bf)
    adj = torch.einsum("bcqhp,bcqn->bchpn", dy * ec[..., None], Cf)
    decay = torch.exp(clast)[..., None, None]  # (b,nc,H,1,1)
    h_in = torch.empty_like(own)
    dh = torch.empty_like(adj)
    h = torch.zeros((b, H, P, N), dtype=acc, device=x.device)
    for c in range(nc):
        h_in[:, c] = h
        h = decay[:, c] * h + own[:, c]
    d = gstate.to(acc)
    for c in reversed(range(nc)):
        dh[:, c] = d
        d = decay[:, c] * d + adj[:, c]
    del own, adj

    # 2. per chunk
    above = ~torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    dx = torch.empty((b, nc, Q, H, P), dtype=acc, device=x.device)
    ddt = torch.empty((b, nc, Q, H), dtype=acc, device=x.device)
    dB = torch.empty((b, nc, Q, N), dtype=acc, device=x.device)
    dC = torch.empty_like(dB)
    dA = torch.zeros(H, dtype=acc, device=x.device)
    for c in range(nc):
        cq, wq, eq = cums[:, c], w[:, c], ec[:, c]  # (b,Q,H)
        xk, xbk, dyk, dtk = xf[:, c], xb[:, c], dy[:, c], dtf[:, c]
        Bk, Ck = Bf[:, c], Cf[:, c]  # (b,Q,N)
        hk, dhk = h_in[:, c], dh[:, c]  # (b,H,P,N)
        seg = cq[:, :, None, :] - cq[:, None, :, :]  # (b,q,k,H)
        L = torch.exp(seg.masked_fill(above[None, :, :, None], float("-inf")))
        G = L * (Ck @ Bk.transpose(1, 2))[..., None]
        dG = torch.einsum("bqhp,bkhp->bqkh", dyk, xbk)
        v = torch.einsum("bhpn,bkn->bkhp", dhk, Bk)  # dh B[k]
        dxb = torch.einsum("bqkh,bqhp->bkhp", G, dyk) + wq[..., None] * v
        dx[:, c] = dtk[..., None] * dxb + D[:, None] * dyk
        dGG = dG * G
        yo = torch.einsum("bqn,bhpn->bqhp", Ck, hk) * eq[..., None]
        wdw = wq * (xbk * v).sum(-1)  # w[k] xb[k] . dh B[k]
        dcums = dGG.sum(2) - dGG.sum(1) + (dyk * yo).sum(-1) - wdw
        dcums[:, -1] += wdw.sum(1) + torch.exp(clast[:, c]) * (
            dhk * hk).sum((-1, -2))
        da = dcums.flip(1).cumsum(1).flip(1)
        ddt[:, c] = (xk * dxb).sum(-1) + A * da
        dA += (dtk * da).sum((0, 1))
        M = (dG * L).sum(-1)  # (b,q,k): summed over the heads
        dC[:, c] = M @ Bk + torch.einsum("bqh,bqhp,bhpn->bqn", eq, dyk, hk)
        dB[:, c] = M.transpose(1, 2) @ Ck + torch.einsum(
            "bkh,bkhp,bhpn->bkn", wq, xbk, dhk)
    dD = (xf * dy).sum((0, 1, 2, 4))
    return (dx.reshape(b, S, H, P).to(x.dtype), ddt.reshape(b, S, H), dA,
            dB.reshape(b, S, N).to(x.dtype), dC.reshape(b, S, N).to(x.dtype),
            dD)


def f64_tol(own_err: float, scale: float) -> float:
    """Max-abs-error tolerance of a float32 gradient of kernel D (the
    backward kernel's or :func:`ssd_scan_bwd_plain`'s) against float64
    autograd through :func:`ssd_scan_plain`, where plain float32 autograd
    through the same function errs by ``own_err`` and the float64
    gradient's magnitude is ``scale``.

    Both float32 backwards sum the same float32 terms in other orders, so
    4 times autograd's own error covers the order's effect with margin
    (1.6 times is the most observed where that error is above 2e-7 of the
    magnitude); 1e-6 of the magnitude, some eight float32 roundings,
    covers inputs on which autograd happens to err by less (up to 5.5
    times a smaller error observed)."""
    return 4.0 * own_err + 1e-6 * scale


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
