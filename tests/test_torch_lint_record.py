"""The lint's record of one run (``apex_tpu_torch.lint.record``) and
``lint_step``'s contract around it, on the CPU.

- The record of a small BERT step (O1 bf16, arena LAMB) holds its forward,
  then its backward, then the update, in order; each hand-kernel call is
  one node by its ``ops.KERNELS`` name, with the plain version's aten ops
  hidden, at the counts the step launches.
- Each kernel's declared in-place writes (``ops.KERNEL_WRITES``) match
  what its plain version writes in place, for every kernel whose plain
  version the CPU reaches; a declared write the record cannot see (a
  card kernel writes through ``ctypes`` or Triton) is still copied and
  put back.
- ``lint_step`` calls the step exactly once, makes one record shared by
  every pass (none when the rules need none, none with ``record=``), and
  leaves the caller's state, its generators and its closed-over buffers
  bitwise as they were, so the next step equals a never-linted twin's.
- The compiled-program parameters raise ``NotImplementedError`` naming
  ROADMAP item 12b.
"""

import collections

import numpy as np
import pytest
import torch

from apex_tpu_torch import lint, models, ops, optim, train
from apex_tpu_torch.ops import _priced
from apex_tpu_torch.utils import tree_leaves


def _bert(dropout=0.0, seed=0):
    enc = models.BertEncoder(512, hidden=32, layers=2, heads=2,
                             max_len=160 if dropout else 16,
                             dropout=dropout, device="cpu", seed=seed)
    seq = 160 if dropout else 16
    step, state, (toks, labels), policy, _ = train.build_bert_step(
        2, seq, encoder=enc, device="cpu", strategy="arena", vocab=512,
        padded=bool(dropout))
    return step, state, toks, labels, policy


def test_forward_then_backward_in_order_with_kernel_nodes():
    step, state, toks, labels, _ = _bert()
    rec = lint.record_step(step, state, toks, labels)
    phases = [n.phase for n in rec.nodes]
    first_b = phases.index("backward")
    last_b = len(phases) - 1 - phases[::-1].index("backward")
    assert set(phases[:first_b]) == {"forward"}
    assert set(phases[first_b:last_b + 1]) == {"backward"}
    assert set(phases[last_b + 1:]) == {"forward"}       # the update
    kinds = collections.Counter((n.op, n.phase) for n in rec.nodes
                                if n.kind == "kernel")
    assert kinds == {("layer_norm_fwd", "forward"): 5,
                     ("flash_attn_fwd", "forward"): 2,
                     ("xentropy_fwd", "forward"): 1,
                     ("xentropy_bwd", "backward"): 1,
                     ("flash_attn_bwd", "backward"): 2,
                     ("layer_norm_bwd", "backward"): 5,
                     ("multi_tensor_l2norm", "forward"): 1,
                     ("lamb_stage1", "forward"): 1,
                     ("lamb_stage2", "forward"): 1}
    assert rec.kernel_counts() == collections.Counter(
        {k: v for (k, _), v in kinds.items()})
    order = [n.op for n in rec.nodes if n.kind == "kernel"]
    assert order.index("layer_norm_bwd") > max(
        i for i, k in enumerate(order) if k == "layer_norm_fwd")
    counts = rec.counts()
    assert counts["nodes"] == counts["aten"] + counts["kernel"]
    assert counts["inputs"] == len(tree_leaves(state)) + 2
    # every committed output is a value of the record, named by its path
    assert all(rec.output_paths[v].startswith("result") for v in rec.outputs)
    # each node's operands are values made before it
    made = set(rec.inputs)
    for n in rec.nodes:
        for v in n.tensor_operands:
            assert v in made or rec.values[v].origin in ("const", "op")
        made.update(n.outputs)


def test_a_plain_version_is_one_kernel_node():
    from apex_tpu_torch.ops import attention
    q, k, v = (torch.randn(1, 8, 2, 16) for _ in range(3))
    rec = lint.record_step(lambda q, k, v: attention.flash_fwd_plain(
        q, k, v, 0.25), q, k, v)
    assert [(n.kind, n.op) for n in rec.nodes] == [("kernel",
                                                    "flash_attn_fwd")]
    node = rec.nodes[0]
    assert node.tensor_operands == rec.inputs
    assert [rec.values[o].dtype for o in node.outputs] == [torch.float32,
                                                          torch.float32]


def _kernel_steps():
    """Zero-arg calls reaching every kernel whose plain version the CPU
    runs: BERT (arena LAMB), a ResNet (arena SGD), the MLP step (Adam),
    NovoGrad and Adagrad on an arena, and the public multi-tensor ops."""
    step, state, toks, labels, _ = _bert()
    tm = models.ResNet(stage_sizes=[1, 1], num_classes=10, width=8,
                       dtype=torch.bfloat16, device="cpu")
    rstep, (rs, bs), (x, y), _, _ = train.build_resnet_step(
        4, 32, model=tm, device="cpu", strategy="arena")
    mstep, ms, (mx, mt), _, _ = train.build_mlp_step(
        16, (13, 32, 16, 8), device="cpu")
    params = {"w": torch.randn(64, 64), "b": torch.randn(64)}
    grads = {k: torch.randn_like(p) for k, p in params.items()}
    nvg = optim.FusedNovoGrad(lr=1e-3, strategy="arena")
    ada = optim.FusedAdagrad(lr=1e-2, strategy="arena")
    buf = torch.randn(2 * 65536)

    def multi():
        ops.multi_tensor_scale(buf, 0.5)
        ops.multi_tensor_axpby(2.0, buf, 3.0, buf)
        return ops.multi_tensor_maxnorm(buf)

    return [lambda: step(state, toks, labels),
            lambda: rstep(rs, bs, x, y), lambda: mstep(ms, mx, mt),
            lambda: nvg.step(grads, nvg.init(params), params),
            lambda: ada.step(grads, ada.init(params), params), multi]


def test_declared_writes_match_the_plain_versions():
    seen = {}
    for fn in _kernel_steps():
        for n in lint.record_step(fn).nodes:
            if n.kind == "kernel":
                seen.setdefault(n.op, set()).add(n.hidden_writes)
                assert not n.writes
    # the generic flash kernels share flash_attn's plain versions, the
    # only flash the CPU runs
    assert set(seen) == set(ops.KERNELS) - {"flash_generic_fwd",
                                            "flash_generic_bwd"}
    for name in ops.KERNELS:
        assert ops.KERNEL_WRITES[name] == ()
        assert seen.get(name, {()}) == {()}, name


def test_hidden_writes_are_seen_and_declared_writes_put_back(monkeypatch):
    @_priced.priced("adam")
    def writes_plainly(p):
        p.add_(1.0)
        return p * 1.0

    @_priced.priced("adam")
    def writes_unseen(p):
        p.numpy()[:] += 1.0          # as a card kernel: no _version bump
        return p * 1.0

    buf = torch.zeros(4)
    rec = lint.record_step(lambda: writes_plainly(buf))
    node, = rec.nodes
    assert node.hidden_writes and buf.eq(0).all()      # copied, put back
    lint.record_step(lambda: writes_unseen(buf))
    assert buf.eq(1).all()                    # undeclared: left written
    buf.zero_()
    monkeypatch.setitem(ops.KERNEL_WRITES, "adam", ("p",))
    rec = lint.record_step(lambda: writes_unseen(buf))
    node, = rec.nodes
    (old, new), = node.writes
    assert new in rec.outputs and buf.eq(0).all()


def test_lint_step_runs_the_step_once_on_one_shared_record(monkeypatch):
    step, state, toks, labels, policy = _bert()
    calls, made = [], []

    def counted(*a):
        calls.append(1)
        return step(*a)

    real = lint.record_step
    monkeypatch.setattr(lint, "record_step",
                        lambda *a, **k: made.append(1) or real(*a, **k))
    rep = lint.lint_step(counted, state, toks, labels, policy=policy)
    assert calls == [1] and made == [1]
    assert rep.fn_name == "counted"
    rec = real(counted, state, toks, labels)
    calls.clear()
    made.clear()
    again = lint.lint_step(None, record=rec, policy=policy)
    assert calls == [] and made == []
    assert [f.fingerprint() for f in again] == [f.fingerprint()
                                                for f in rep]
    assert len(lint.lint_step(counted, state, toks, labels, rules=())) == 0
    assert calls == [] and made == []


def test_lint_leaves_no_trace():
    step, state, toks, labels, policy = _bert(dropout=0.1)
    twin, tstate, _, _, _ = _bert(dropout=0.1)
    before = [t.clone() for t in tree_leaves(state)]
    gen_before = step.generator.get_state().clone()
    default_before = torch.default_generator.get_state().clone()
    closure = torch.arange(6.0)
    carried_gen = torch.Generator().manual_seed(5)
    carried_before = carried_gen.get_state().clone()

    def noisy(state, toks, labels, g):
        closure.add_(1.0)                      # a closed-over buffer
        closure[2:4].mul_(3.0)                 # ... through a view
        g.manual_seed(9)                       # a carried generator
        torch.rand(3, generator=g)
        torch.rand(3)                          # the default generator
        return step(state, toks, labels)

    rep = lint.lint_step(noisy, state, toks, labels, carried_gen,
                         policy=policy)
    assert rep.errors == [] or {f.rule for f in rep.errors} == {
        "nondeterminism"}
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state),
                                                  before))
    assert torch.equal(step.generator.get_state(), gen_before)
    assert torch.equal(torch.default_generator.get_state(), default_before)
    assert torch.equal(carried_gen.get_state(), carried_before)
    assert torch.equal(closure, torch.arange(6.0))
    for _ in range(2):
        state, loss = step(state, toks, labels)
        tstate, tloss = twin(tstate, toks, labels)
        assert torch.equal(loss, tloss)


def test_compiled_program_parameters_wait_for_item_12b():
    x = torch.ones(4)
    for kw in (dict(compiled=object()), dict(hlo_text="HloModule m"),
               dict(known_scopes=("ddp/",)), dict(min_donation_bytes=0),
               dict(mesh_model=lint.parse_mesh_spec(
                   "dp2x2", link_bytes_per_s={"ici": 1e11, "dcn": 1e10})),
               dict(per_rank_hlo={0: ""}), dict(precision={"sites": ()}),
               dict(rules=("donation-miss",)),
               dict(rules=("wire-dtype-unsafe",))):
        with pytest.raises(NotImplementedError, match="item 12b"):
            lint.lint_step(lambda x: x * 2, x, **kw)
    with pytest.raises(ValueError, match="unknown lint rules"):
        lint.lint_step(lambda x: x * 2, x, rules=("no-such-rule",))
    assert len(lint.lint_step(lambda x: x * 2, x, precision=False)) == 0


def test_values_are_versioned_and_views_share_storage():
    base = torch.zeros(4)

    def step(x):
        v = x.view(2, 2)
        v.add_(1.0)                 # writes x through a view
        return x * 2                # reads x's new version

    rec = lint.record_step(step, base)
    add = next(n for n in rec.nodes if n.op == "aten::add_.Tensor")
    mul = next(n for n in rec.nodes if n.op == "aten::mul.Tensor")
    (old, new), = add.writes
    assert mul.tensor_operands[0] not in (rec.inputs[0], old)
    assert rec.values[mul.tensor_operands[0]].origin == "version"
    assert rec.values[mul.tensor_operands[0]].node == add.index
    assert rec.written and base.eq(0).all()
    assert np.array_equal(rec.values[rec.inputs[0]].shape, (4,))
