"""Serving the encoder-decoder family (reduced whisper-tiny, float32, on the
CPU) in the port against the JAX package, with the same (perturbed,
``tests/_torch_archs.py``) parameters on both sides.  Every request
carries its own seeded encoder frames (``extras``):

* a ``ServeEngine`` with ``extras_template``: continuous batching (a
  request joining in flight) bitwise equal to a serial run through a
  fresh engine, and both equal to the reference ``ServeEngine``'s tokens
  for the same submit and step order;
* ``submit`` with extras and no template, or a template and no extras,
  raises ``ValueError`` in both packages;
* a ``Router`` over two engines loses replica 0 mid-decode: every request,
  re-prefilled from its own frames on the survivor, ends with its serial
  tokens;
* ``serve_batch(batch_extras=)`` equal to the reference's; the multi-rank
  path refuses extras, as the reference's meshed path does;
  ``python -m repro_torch.launch.serve --arch whisper-tiny`` runs;
* the 2x2 tensor-parallel engine (a 4-rank gloo world,
  ``tests/_torch_world.py serve_whisper``) gives the single-device
  tokens, continuous and serial.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.serve import serve_batch as j_serve_batch
from repro.serve import PromptBuckets as JBuckets
from repro.serve import ServeEngine as JEngine
from repro_torch import tree
from repro_torch.core import CommContext, Topology
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.serve import serve_batch
from repro_torch.serve import PromptBuckets, Router, ServeEngine
from repro_torch.serve.scheduler import FINISHED

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_world as tw  # noqa: E402
from _torch_archs import make_pair  # noqa: E402

GEN = 6


@pytest.fixture(scope="module")
def pair():
    return make_pair("whisper-tiny")


def _template(cfg):
    return {"frames": torch.empty((1, tw.WHISPER_FRAMES, cfg.d_model),
                                  device="meta")}


def _engine(pair, **kw):
    return ServeEngine(pair.model, num_slots=tw.SERVE_SLOTS,
                       max_len=tw.SERVE_MAX_LEN,
                       buckets=PromptBuckets(tw.SERVE_BUCKETS),
                       extras_template=_template(pair.cfg), device="cpu",
                       **kw)


def _jengine(pair):
    D = pair.cfg.d_model
    return JEngine(pair.jmodel, pair.jparams, num_slots=tw.SERVE_SLOTS,
                   max_len=tw.SERVE_MAX_LEN,
                   buckets=JBuckets(tw.SERVE_BUCKETS),
                   extras_template={"frames": jax.ShapeDtypeStruct(
                       (1, tw.WHISPER_FRAMES, D), jnp.float32)})


@pytest.fixture(scope="module")
def streams(pair):
    """Serial and continuous streams of the port, and the reference
    engine's continuous streams."""
    serial = tw.whisper_serial(_engine(pair), pair.cfg)
    cont = tw.whisper_streams(_engine(pair), pair.cfg)
    ref = tw.whisper_streams(_jengine(pair), pair.cfg)
    return serial, cont, ref


def test_engine_continuous_equals_serial(streams):
    serial, cont, _ = streams
    assert cont == serial
    assert [len(s) for s in serial] == [b for _, b, _ in tw.WHISPER_WORKLOAD]


def test_engine_tokens_equal_the_reference_engine(streams):
    serial, _, ref = streams
    assert serial == ref


def test_each_request_attends_its_own_frames(pair, streams):
    """The same prompt with other frames gives another stream: the slot's
    encoder output is the request's own."""
    serial, _, _ = streams
    p, b, f = tw.WHISPER_WORKLOAD[0]
    engine = _engine(pair)
    req = engine.submit(p, b, extras=tw.whisper_extras(pair.cfg, f + 7))
    assert engine.run()[req.rid] != serial[0]


def test_submit_extras_must_match_the_template(pair):
    extras = tw.whisper_extras(pair.cfg, 0)
    with pytest.raises(ValueError):
        _engine(pair).submit([1, 2], 2)
    with pytest.raises(ValueError):
        _jengine(pair).submit([1, 2], 2)
    plain = dict(num_slots=2, max_len=8)
    with pytest.raises(ValueError):
        ServeEngine(pair.model, device="cpu", **plain).submit(
            [1, 2], 2, extras=extras)
    # the reference's engine without a template builds no enc-dec cache
    # at all (its init_decode asserts frames); its submit check is the same
    with pytest.raises(AssertionError, match="frames"):
        JEngine(pair.jmodel, pair.jparams, **plain)


def test_router_fail_replica_resumes_with_frames(pair, streams):
    serial, _, _ = streams
    a, b = _engine(pair), _engine(pair)
    router = Router([a, b])
    reqs = [router.submit(p, n, extras=tw.whisper_extras(pair.cfg, f))
            for p, n, f in tw.WHISPER_WORKLOAD]
    for _ in range(2):
        a.step()
        b.step()
    resumed = [r.rid for r in reqs
               if r.generated and router.placement[r.rid] == 0]
    assert resumed, "no request was mid-stream on the lost replica"
    assert all(r.extras is not None for r in reqs)
    router.fail_replica(0)
    while not b.idle:
        b.step()
    for r, want in zip(reqs, serial):
        assert r.state == FINISHED and r.generated == want


def _batch_inputs(cfg, B=3, P_len=5):
    rng = np.random.default_rng(11)
    prompts = rng.integers(0, cfg.vocab_size, (B, P_len)).astype(np.int32)
    frames = (rng.standard_normal((B, tw.WHISPER_FRAMES, cfg.d_model))
              * 0.5).astype(np.float32)
    return prompts, frames


def test_serve_batch_with_extras_matches_reference(pair):
    prompts, frames = _batch_inputs(pair.cfg)
    ref = np.asarray(j_serve_batch(
        pair.jmodel, pair.jparams, jnp.asarray(prompts), gen_len=GEN,
        max_len=16, batch_extras={"frames": jnp.asarray(frames)}))
    got = serve_batch(pair.model, torch.from_numpy(prompts), gen_len=GEN,
                      max_len=16, batch_extras={"frames": frames},
                      device="cpu")
    np.testing.assert_array_equal(got.numpy(), ref)
    # each row as a request through the engine: the same tokens
    engine = _engine(pair)
    reqs = [engine.submit(list(prompts[i]), GEN,
                          extras={"frames": frames[i : i + 1]})
            for i in range(len(prompts))]
    out = engine.run()
    assert [out[r.rid] for r in reqs] == ref.tolist()


def test_serve_batch_multi_rank_refuses_extras(pair):
    prompts, frames = _batch_inputs(pair.cfg, B=1)
    ctx = CommContext(Topology.of(2, 2))  # refused before any group is used
    with pytest.raises(NotImplementedError, match="multi-rank"):
        serve_batch(pair.model, torch.from_numpy(prompts), gen_len=2,
                    batch_extras={"frames": frames}, ctx=ctx, device="cpu")


def test_launch_serve_main_serves_whisper(capsys):
    launch_serve.main(["--arch", "whisper-tiny", "--reduced", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "4",
                       "--gen", "3"])
    out = capsys.readouterr().out
    assert "whisper-tiny-smoke on cpu: generated (2, 3) tokens" in out


@pytest.fixture(scope="module")
def tp_world(tmp_path_factory, pair):
    out = tmp_path_factory.mktemp("serve_whisper")
    np.savez(out / "params0.npz",
             **{f"leaf{i}": a for i, a in
                enumerate(tree.leaves(pair.np_params))})
    return tw.spawn_world("serve_whisper", out, world=4)


def test_tp_engine_serves_whisper_with_the_single_device_tokens(tp_world,
                                                                streams):
    serial, _, _ = streams
    for rank, row in enumerate(tp_world):
        for i, want in enumerate(serial):
            assert row[f"serial{i}"].tolist() == want, (rank, i)
            assert row[f"cont{i}"].tolist() == want, (rank, i)


def test_engine_build_runs_the_encoder_once_at_b1(pair, monkeypatch):
    """Building an engine runs the encoder once, on one row of zero frames
    broadcast over the free slot rows, as the reference's
    ``_init_slot_cache`` (``repro/serve/engine.py:152-163``) does; before
    the fix it ran ``b_max`` rows."""
    from repro_torch.models import model as model_mod

    passes, batches = [], []
    encode = model_mod._encode
    init_decode = pair.model.init_decode

    def counting_encode(params, frames, cfg, *a, **kw):
        passes.append(tuple(frames.shape))
        return encode(params, frames, cfg, *a, **kw)

    def recording_init_decode(batch_size, max_len, batch=None):
        batches.append(batch_size)
        return init_decode(batch_size, max_len, batch=batch)

    monkeypatch.setattr(model_mod, "_encode", counting_encode)
    monkeypatch.setattr(pair.model, "init_decode", recording_init_decode)
    engine = _engine(pair)
    assert engine.b_max > 1
    assert batches == [1]
    assert passes == [(1, tw.WHISPER_FRAMES, pair.cfg.d_model)]
    enc = engine._cache["enc_out"]
    assert enc.shape[0] == engine.b_max
    assert torch.equal(enc, enc[:1].expand_as(enc))
