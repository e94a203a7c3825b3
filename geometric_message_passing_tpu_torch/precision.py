"""The port's matrix-product precision policy: the one place where the JAX
package's ``precision=`` arguments and its ``--matmul_precision`` flag are
given a meaning on the card.

Names (the JAX package's) and what they compute here, for float32 operands:

* ``highest`` / ``float32``: exact IEEE float32 products (no TF32).  This is
  PyTorch's own default, and what the port computes with no flag;
* ``tensorfloat32``: TF32 tensor cores (cuBLAS with
  ``torch.backends.cuda.matmul.allow_tf32``), as XLA:GPU does for the name;
* ``bfloat16_3x``: each operand split into ``hi = bf16(a)`` and ``lo =
  bf16(a - hi)``, the product ``hi.hi + hi.lo + lo.hi`` accumulated in f32.
  A bf16 value is exact in TF32, so each of the three is a tensor-core
  product with TF32 allowed (f32 output; a ``torch.matmul`` of bf16
  tensors would round its output to bf16).  A product of three or more
  operands (a multi-operand einsum) keeps every term with at most one
  ``lo`` and runs them in exact f32, since its intermediates are not bf16;
* ``default``: the process default.

A product site whose precision is None follows the process default, which
is ``highest`` unless ``matmul_precision(name)`` (the CLI's
``--matmul_precision``) lowers it.  That context manager also sets
``torch.backends.cuda.matmul.allow_tf32`` (True for ``tensorfloat32``,
False otherwise) so that a product outside this module follows the process
default as far as torch can: under ``bfloat16_3x`` such a product is exact
f32.  It restores both on exit.

A site's precision holds in its backward too: the flag is process-global and
read when cuBLAS is called, so a scoped product that differs from the flag
runs as a ``torch.autograd.Function`` whose forward and backward both set it
(``_Scoped``), and a ``bfloat16_3x`` product's backward takes its transposed
products in ``bfloat16_3x`` as well (``_Split3``).  Where the site's
precision is what the flag gives anyway, the product is the plain torch call,
so with no flag every number is the one the port computed before.
Operands that are not float32 (bf16, float64) take the plain torch call.

The hand-written kernels (K1-K7) ignore precision: they compute with f32
FMAs whatever the site or the flag says.  K7 is at 77-83% of its byte bound,
so TF32 would buy it nothing.

``record()`` collects ``(site, precision)`` for every product routed here,
so a test can see which products a scope sends to the process default.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import torch
from torch.nn import functional as F

NAMES = ("default", "tensorfloat32", "float32", "bfloat16_3x", "highest")
_CANONICAL = {"highest": "highest", "float32": "highest",
              "tensorfloat32": "tensorfloat32", "bfloat16_3x": "bfloat16_3x"}

_process = "highest"            # the process default, canonical
_recorders: List[list] = []


def canonical(name: Optional[str]) -> str:
    """``name`` as the precision it computes: ``highest``,
    ``tensorfloat32`` or ``bfloat16_3x`` (None and ``default``: the process
    default).  ``ValueError`` for a name the JAX package does not have."""
    if name is None or name == "default":
        return _process
    try:
        return _CANONICAL[name]
    except KeyError:
        raise ValueError(f"precision must be one of {NAMES} or None, got "
                         f"{name!r}") from None


def process_default() -> str:
    return _process


@contextlib.contextmanager
def matmul_precision(name: Optional[str]) -> Iterator[str]:
    """Set the process default to ``name`` (None or ``default``: exact f32,
    PyTorch's default) and torch's TF32 flag to match, for the ``with``
    block; both are restored on exit."""
    global _process
    new = "highest" if name in (None, "default") else canonical(name)
    saved = (_process, torch.backends.cuda.matmul.allow_tf32)
    _process = new
    torch.backends.cuda.matmul.allow_tf32 = new == "tensorfloat32"
    try:
        yield new
    finally:
        _process = saved[0]
        torch.backends.cuda.matmul.allow_tf32 = saved[1]


def check_flags() -> None:
    """``ValueError`` if torch's TF32 flag disagrees with the process
    default: someone set it outside ``matmul_precision``."""
    want = _process == "tensorfloat32"
    if torch.backends.cuda.matmul.allow_tf32 != want:
        raise ValueError(
            f"torch.backends.cuda.matmul.allow_tf32 is "
            f"{torch.backends.cuda.matmul.allow_tf32} under the process "
            f"precision {_process!r}: set it through "
            "precision.matmul_precision(name), or set it to False")


@contextlib.contextmanager
def record() -> Iterator[List[Tuple[Optional[str], Optional[str]]]]:
    """Collect ``(site, precision)`` of every product routed through this
    module inside the block (``precision`` as the site asked, None for the
    process default)."""
    seen: list = []
    _recorders.append(seen)
    try:
        yield seen
    finally:
        _recorders.remove(seen)


@contextlib.contextmanager
def _tf32(allow: bool):
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def split_bf16(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)``, float32 tensors holding bf16 values: ``hi = bf16(x)``,
    ``lo = bf16(x - hi)``."""
    hi = x.to(torch.bfloat16).to(x.dtype)
    return hi, (x - hi).to(torch.bfloat16).to(x.dtype)


def _split3_eval(fn, his, los) -> torch.Tensor:
    """``fn`` (linear in each operand) in ``bfloat16_3x`` from the operands'
    splits: the term of every ``hi`` and, for each operand, the term with
    its ``lo``, summed in f32; two operands on tensor cores (TF32 is exact
    on bf16 values), more in exact f32."""
    with _tf32(len(his) == 2):
        out = fn(*his)
        for j, lo in enumerate(los):
            out = out + fn(*his[:j], lo, *his[j + 1:])
    return out


class _Split3(torch.autograd.Function):
    """``fn(*xs)`` in ``bfloat16_3x``; its backward takes each operand's
    vector-Jacobian product in ``bfloat16_3x`` too: the cotangent and the
    other operands split, the terms with at most one ``lo``."""

    @staticmethod
    def forward(ctx, fn, *xs):
        parts = [split_bf16(x) for x in xs]
        his, los = [p[0] for p in parts], [p[1] for p in parts]
        ctx.fn = fn
        ctx.save_for_backward(*his, *los)
        return _split3_eval(fn, his, los)

    @staticmethod
    def backward(ctx, g):
        n = len(ctx.needs_input_grad) - 1
        saved = ctx.saved_tensors
        his, los = saved[:n], saved[n:]
        need = ctx.needs_input_grad[1:]
        grads = [None] * n

        def add(i, gi):
            grads[i] = gi if grads[i] is None else grads[i] + gi

        g_hi, g_lo = split_bf16(g)
        with torch.enable_grad(), _tf32(n == 2):
            # the all-hi term with each part of the cotangent
            want = [i for i in range(n) if need[i]]
            leaves = [h.detach().requires_grad_(need[i])
                      for i, h in enumerate(his)]
            y = ctx.fn(*leaves)
            for cot, keep in ((g_hi, True), (g_lo, False)):
                got = torch.autograd.grad(y, [leaves[i] for i in want], cot,
                                          retain_graph=keep)
                for i, gi in zip(want, got):
                    add(i, gi)
            # operand j's lo with the cotangent's hi: the other operands'
            for j in range(n):
                want = [i for i in range(n) if need[i] and i != j]
                if not want:
                    continue
                leaves = [h.detach().requires_grad_(i in want)
                          for i, h in enumerate(his)]
                leaves[j] = los[j]
                got = torch.autograd.grad(ctx.fn(*leaves),
                                          [leaves[i] for i in want], g_hi)
                for i, gi in zip(want, got):
                    add(i, gi)
        return (None, *grads)


class _Scoped(torch.autograd.Function):
    """``fn(*xs)`` with torch's TF32 flag set to ``allow`` in the forward
    and in the backward (recomputed there under the flag)."""

    @staticmethod
    def forward(ctx, fn, allow, *xs):
        ctx.fn, ctx.allow = fn, allow
        ctx.save_for_backward(*xs)
        with _tf32(allow):
            return fn(*xs)

    @staticmethod
    def backward(ctx, g):
        xs = ctx.saved_tensors
        want = [i for i, n in enumerate(ctx.needs_input_grad[2:]) if n]
        grads = [None] * len(xs)
        if not want:
            return (None, None, *grads)
        with torch.enable_grad(), _tf32(ctx.allow):
            leaves = [x.detach().requires_grad_(i in want)
                      for i, x in enumerate(xs)]
            got = torch.autograd.grad(ctx.fn(*leaves),
                                      [leaves[i] for i in want], g)
        for i, gi in zip(want, got):
            grads[i] = gi
        return (None, None, *grads)


def product(fn: Callable[..., torch.Tensor], xs: Sequence[torch.Tensor],
            precision: Optional[str] = None,
            site: Optional[str] = None) -> torch.Tensor:
    """``fn(*xs)``, a product linear in each operand of ``xs``, at the
    precision ``precision`` (None: the process default)."""
    for seen in _recorders:
        seen.append((site, precision))
    name = canonical(precision)
    if not any(x.dtype == torch.float32 for x in xs):
        return fn(*xs)
    grad = torch.is_grad_enabled() and any(x.requires_grad for x in xs)
    if name == "bfloat16_3x":
        if grad:
            return _Split3.apply(fn, *xs)
        parts = [split_bf16(x) for x in xs]
        return _split3_eval(fn, [p[0] for p in parts], [p[1] for p in parts])
    allow = name == "tensorfloat32"
    if (allow == torch.backends.cuda.matmul.allow_tf32
            or not any(x.is_cuda for x in xs)):
        return fn(*xs)
    if grad:
        return _Scoped.apply(fn, allow, *xs)
    with _tf32(allow):
        return fn(*xs)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: Optional[str] = None,
           site: Optional[str] = None) -> torch.Tensor:
    """``a @ b`` at ``precision``."""
    return product(torch.matmul, (a, b), precision, site)


def bmm(a: torch.Tensor, b: torch.Tensor, precision: Optional[str] = None,
        site: Optional[str] = None) -> torch.Tensor:
    """``torch.bmm(a, b)`` at ``precision``."""
    return product(torch.bmm, (a, b), precision, site)


def einsum(equation: str, *operands: torch.Tensor,
           precision: Optional[str] = None,
           site: Optional[str] = None) -> torch.Tensor:
    """``torch.einsum(equation, *operands)`` at ``precision``."""
    return product(lambda *xs: torch.einsum(equation, *xs), operands,
                   precision, site)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None,
           precision: Optional[str] = None,
           site: Optional[str] = None) -> torch.Tensor:
    """``F.linear(x, weight, bias)`` at ``precision`` (``bfloat16_3x``: the
    split product, then the bias added)."""
    if bias is not None and canonical(precision) != "bfloat16_3x":
        return product(F.linear, (x, weight, bias), precision, site)
    y = product(F.linear, (x, weight), precision, site)
    return y if bias is None else y + bias


def addmm(bias: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
          precision: Optional[str] = None,
          site: Optional[str] = None) -> torch.Tensor:
    """``torch.addmm(bias, a, b)`` at ``precision`` (``bfloat16_3x``: the
    split product, then the bias added)."""
    if canonical(precision) != "bfloat16_3x":
        return product(torch.addmm, (bias, a, b), precision, site)
    return product(torch.mm, (a, b), precision, site) + bias
