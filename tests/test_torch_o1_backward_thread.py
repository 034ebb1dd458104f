"""The O1 functional patch reaches a backward run on another thread.

For CUDA tensors autograd runs a custom Function's backward on its own
device thread, which carries the caller's torch-function mode stack but
not Python's ``threading.local``. These CPU tests stand in for that
thread: with the thread-local policy stack emptied inside the backward (as
a device thread sees it), :func:`half_operand_dtype` still finds the
caller's half dtype through the mode that the wrapped ``backward()``/
``autograd.grad`` pushes, and a backward started inside ``auto_cast``
gives the same grads bit for bit as with the stack in place; the forward
runs with no mode, and outside the scope nothing is carried. The card's
own check is ``chip_smoke.py``'s o1_backward_thread phase.
"""

import contextlib

import numpy as np
import torch
from torch.func import functional_call

from apex_tpu_torch import amp as tamp
from apex_tpu_torch import ops as tops
from apex_tpu_torch.amp import functional_patch as fp

O1 = tamp.Policy.from_opt_level("O1")
O1_F16 = tamp.Policy.from_opt_level("O1", half_dtype=torch.float16)


@contextlib.contextmanager
def _device_thread_view():
    """This thread's policy stack hidden, as autograd's device thread has
    none of its own."""
    saved = fp._stack()[:]
    fp._stack().clear()
    try:
        yield
    finally:
        fp._stack().extend(saved)


def _modes():
    return [m for m in torch.overrides._get_current_function_mode_stack()
            if isinstance(m, fp._PolicyMode)]


class _Probe(torch.autograd.Function):
    """An identity whose backward records what a device thread would see:
    the half dtype with the thread's own stack hidden, and the carriers."""

    seen: list = []

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        with _device_thread_view():
            _Probe.seen.append((fp.half_operand_dtype(), len(_modes())))
        return g


def _probe(start):
    _Probe.seen = []
    x = torch.ones(3, requires_grad=True)
    start(_Probe.apply(x).sum(), x)
    return _Probe.seen


_STARTS = {
    "Tensor.backward": lambda y, x: y.backward(),
    "autograd.backward": lambda y, x: torch.autograd.backward(y),
    "autograd.grad": lambda y, x: torch.autograd.grad(y, x),
}


def test_the_mode_carries_the_innermost_policy():
    assert fp.half_operand_dtype() is None and _modes() == []
    for name, start in _STARTS.items():
        with tamp.auto_cast(O1):
            assert _probe(start) and _Probe.seen[0][0] == torch.bfloat16, \
                name
            with tamp.auto_cast(O1_F16):
                assert _probe(start)[0][0] == torch.float16, name
            assert _probe(start)[0][0] == torch.bfloat16, name
            with fp.suspend():
                assert _probe(start) == [(None, 0)], name
        assert _probe(start) == [(None, 0)], name
    assert _modes() == [] and fp._patch_count == 0
    with _device_thread_view():
        assert fp.half_operand_dtype() is None


def test_the_forward_runs_without_a_mode():
    a = torch.randn(4, 5)
    with tamp.auto_cast(O1):
        assert _modes() == []
        assert torch.matmul(a, a.T).dtype == torch.bfloat16
        with tamp.auto_cast(O1_F16):
            assert _modes() == []
    assert _modes() == []


def test_the_mode_passes_every_call_through():
    a = torch.randn(4, 5)
    seen = {}

    class Calls(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            seen["carriers"] = len(_modes())
            seen["exp"] = torch.equal(a.exp() + 1, torch.exp(a) + 1)
            seen["matmul"] = torch.matmul(a, a.T).dtype
            return g

    x = torch.ones(3, requires_grad=True)
    with tamp.auto_cast(O1):
        Calls.apply(x).sum().backward()
    assert seen == {"carriers": 1, "exp": True, "matmul": torch.bfloat16}


def _grads(inside, hide):
    m = tops.MLP((13, 64, 32, 8), device="cpu", seed=1)
    x = torch.tensor(np.random.RandomState(1).randn(16, 13).astype(
        np.float32))
    mp = {k: v.detach().requires_grad_(True)
          for k, v in m.named_parameters()}
    saved = []

    def hide_stack(g):
        # runs in the backward before the MLP's: from here on this thread
        # sees the stack as autograd's device thread does
        saved.extend(fp._stack())
        fp._stack().clear()

    with tamp.auto_cast(O1):
        y = functional_call(m, mp, (x,))
        if hide:
            y.register_hook(hide_stack)
        loss = (y * y).sum()
        if inside:
            loss.backward()
            fp._stack().extend(saved)
    if not inside:
        loss.backward()
    return {k: v.grad for k, v in mp.items()}


def test_backward_inside_the_scope_sees_the_policy_without_the_stack():
    on_thread = _grads(True, hide=False)
    carried = _grads(True, hide=True)
    after = _grads(False, hide=False)
    for k in on_thread:
        assert torch.equal(carried[k], on_thread[k]), k
    assert any(not torch.equal(on_thread[k], after[k]) for k in after)
