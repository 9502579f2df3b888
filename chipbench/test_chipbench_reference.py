"""The frozen reference against the port's own plain path (its CPU route)
at a reduced size in float32: the same weights and batches give the same
loss, gradients, packing and logits. The port is imported here only: the
reference itself imports nothing of it."""
import numpy as np
import pytest
import torch

from chipbench import program, registry, traffic, weights
from chipbench.conftest import tiny_cell
from chipbench.reference import train as RT

TRAIN = ["olmo-1b.train-8x2048", "mamba2-780m.train-4x2048"]


def _setup(name):
    cell = tiny_cell(name, dtype="float32")
    conf = cell.config
    ref = registry.reference_module(conf)
    specs = ref.param_specs(conf["sizes"])
    w = weights.make(specs, 11, "cpu")
    return cell, ref, specs, w


@pytest.mark.parametrize("name", TRAIN)
def test_loss_and_gradients_match_the_port(name):
    from repro_torch.models import build_model

    cell, ref, specs, w = _setup(name)
    conf, mix = cell.config, cell.traffic
    cfg = program.config(conf)
    bundle = build_model(cfg)
    model = program.model(cfg, {k: v.clone() for k, v in w.items()})
    docs = traffic.documents(mix, 11, conf["sizes"]["vocab_size"])
    host = RT.batches(RT.pack(docs, mix["seq_len"], mix["format"]), mix["batch"], 5, 1,
                      mix["format"])[0]
    batch = {k: torch.as_tensor(v) for k, v in host.items()}
    loss_p, grads_p = bundle.value_and_grad(model, batch)
    P = {k: v.clone().requires_grad_() for k, v in w.items()}
    loss_r = ref.train_loss(P, batch, conf["sizes"])
    grads_r = dict(zip(P, torch.autograd.grad(loss_r, list(P.values()))))
    assert float(loss_p) == pytest.approx(float(loss_r.detach()), rel=1e-5)
    for k, g in grads_r.items():
        err = float((grads_p[k] - g).norm() / g.norm().clamp_min(1e-12))
        assert err < 1e-3, (k, err)


@pytest.mark.parametrize("name", TRAIN)
def test_packing_and_batches_match_the_port(name):
    from repro_torch.data.pipeline import batches_from_rows, pack_sequences

    cell = tiny_cell(name)
    mix = cell.traffic
    docs = traffic.documents(mix, 2**31 + 99, 512)
    ours = RT.batches(RT.pack(docs, mix["seq_len"], mix["format"]), mix["batch"], 77, 12,
                      mix["format"])
    it = batches_from_rows(pack_sequences(docs, mix["seq_len"]), mix["batch"], seed=77)
    for mine in ours:
        theirs = next(it)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(theirs[k].astype(np.int64), mine[k])


def test_adamw_and_schedule_match_the_port():
    from repro_torch.optim.adamw import adamw_update, init_opt_state
    from repro_torch.optim.schedule import warmup_cosine

    for step in (0, 3, 20, 500, 2000):
        assert float(warmup_cosine(step, 4e-4, 20, 1000)) == pytest.approx(
            RT.learning_rate(step, 4e-4, 20, 1000), rel=1e-6)
    g = torch.Generator().manual_seed(0)
    p0 = {"a": torch.randn(5, 3, generator=g), "b": torch.randn(7, generator=g)}
    grads = [{k: torch.randn(v.shape, generator=g) for k, v in p0.items()} for _ in range(3)]
    port = {k: v.clone() for k, v in p0.items()}
    opt = init_opt_state(port)
    for gr in grads:
        port, opt = adamw_update(gr, opt, port, lr=1e-2)
    it = iter(grads)

    class Fixed:  # the reference's steps with these gradients
        @staticmethod
        def train_loss(P, batch, sz, mode):
            gr = next(it)
            return sum((P[k] * gr[k]).sum() for k in P)

    out = RT.first_steps(Fixed, p0, {k: torch.float32 for k in p0}, [None] * 3, {},
                         {"peak_lr": 1e-2, "warmup": 0, "total": 10**9})
    for k in p0:
        assert out["change_norms"][k] == pytest.approx(float((port[k] - p0[k]).norm()),
                                                       rel=1e-5)


def test_serve_logits_match_the_port_through_its_cache():
    from repro_torch.models import build_model

    cell, ref, specs, w = _setup("olmo-1b.serve-chat-128")
    conf = cell.config
    cfg = program.config(conf)
    bundle = build_model(cfg)
    model = program.model(cfg, {k: v.clone() for k, v in w.items()})
    prompt = torch.arange(300, 340)[None]
    logits, cache = bundle.prefill(model, tokens=prompt, cache_len=64)
    seq, steps = [logits[0]], [int(logits[0].argmax())]
    for _ in range(6):
        logits, cache = bundle.decode_step(model, cache, torch.tensor([[steps[-1]]]))
        seq.append(logits[0])
        steps.append(int(logits[0].argmax()))
    full = torch.cat([prompt[0], torch.tensor(steps[:-1])])[None]
    want = ref.logits(w, full, conf["sizes"], start=prompt.shape[1] - 1)
    np.testing.assert_allclose(torch.stack(seq).numpy(), want.numpy(), atol=2e-4, rtol=1e-4)
