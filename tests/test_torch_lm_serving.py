"""The LM serving path of the port beside the reference, on the CPU:
``serve.engine.embed_texts``, the step builders of ``serve.step`` and
the ``examples/pattern_search.py`` flow (embed a corpus with a smoke
qwen3, index it, serve CONTAINS, boolean/LIKE and tag + range requests,
checkpoint and restore).

The port carries the reference's weights (``from_reference_params``).
Tolerances: embeddings and logits in fp32 within rtol 1e-4 / atol 1e-5;
greedy tokens equal except at a near tie.  Engine answers are compared
with both engines indexing the reference's vectors, so a near tie in
the embeddings cannot flip an answer: the port's host oracle
(``backend="numpy"``) equals the reference's exactly; the port's device
path on the CPU (``backend="torch"``) equals the reference's JAX
executor (same ids, distances within 2e-4 relative), and its graph-free
answers equal the host oracle's.

The reference is imported inside fixtures, so the card, which has no
JAX, can still collect this file.
"""

import importlib
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.core.baselines import ground_truth, recall
from repro_torch.core.predicate import parse_predicate, quote_literal
from repro_torch.core.vectormaton import VectorMatonConfig
from repro_torch.data.corpora import make_corpus, sample_patterns
from repro_torch.models.convert import from_reference_params
from repro_torch.models.transformer import LM
from repro_torch.serve.engine import Request, RetrievalEngine, embed_texts
from repro_torch.serve.step import make_decode, make_prefill

SCALE = 0.05


@pytest.fixture(scope="module")
def ref():
    imp = importlib.import_module
    jax = imp("jax")
    rcfg = imp("repro.configs").smoke_config("qwen3-4b")
    model = imp("repro.models.transformer").LM(rcfg)
    params = model.init(jax.random.PRNGKey(0))
    cfg = smoke_config("qwen3-4b")
    port = LM(cfg, device="cpu")
    port.load_state_dict(from_reference_params(cfg, params))
    return types.SimpleNamespace(
        jax=jax, jnp=imp("jax.numpy"), model=model, params=params,
        port=port, cfg=cfg, engine=imp("repro.serve.engine"),
        step=imp("repro.serve.step"),
        vm=imp("repro.core.vectormaton"))


def tokenize(s: str, vocab: int, width: int = 32) -> np.ndarray:
    """``examples/pattern_search.py``'s byte tokens."""
    raw = np.frombuffer(s[:width].ljust(width).encode(), dtype=np.uint8)
    return (raw % vocab).astype(np.int32)


def test_embed_texts_matches_reference(ref):
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, ref.cfg.vocab_size, (b, 12)).astype(np.int32)
               for b in (3, 5)]
    want = ref.engine.embed_texts(ref.model, ref.params, batches)
    got = embed_texts(ref.port, batches)
    assert got.dtype == np.float32 and got.shape == (8, ref.cfg.d_model)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got, embed_texts(ref.port, batches))


def test_prefill_and_greedy_decode_match_reference(ref):
    """``make_prefill`` + 6 ``make_decode`` steps: the same greedy tokens
    (the reference's fed to both; a differing token must be a near tie of
    the reference's logits)."""
    jnp = ref.jnp
    rng = np.random.default_rng(1)
    toks = rng.integers(0, ref.cfg.vocab_size, (3, 10)).astype(np.int32)
    r_pre = ref.step.make_prefill(ref.model, 16)
    r_dec = ref.step.make_decode(ref.model)
    t_pre, t_dec = make_prefill(ref.port, 16), make_decode(ref.port)
    rc, r_tok = r_pre(ref.params, jnp.asarray(toks))
    tc, t_tok = t_pre(torch.from_numpy(toks))
    assert t_tok.dtype == torch.int32 and tuple(t_tok.shape) == (3,)
    _, r_logits = ref.model.prefill(ref.params, jnp.asarray(toks), 16)
    _, t_logits = ref.port.prefill(torch.from_numpy(toks), 16)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(r_logits),
                               rtol=1e-4, atol=1e-5)
    tol = 2e-4 * float(np.abs(np.asarray(r_logits)).max())
    tok = np.array(r_tok)
    _near_tie_equal(t_tok.numpy(), tok, np.asarray(r_logits), tol)
    for pos in range(10, 16):
        r_logits, _ = ref.model.decode_step(ref.params, rc,
                                            jnp.asarray(tok[:, None]),
                                            jnp.int32(pos))
        r_next, rc = r_dec(ref.params, rc, jnp.asarray(tok[:, None]),
                           jnp.int32(pos))
        t_next, tc = t_dec(tc, torch.from_numpy(tok[:, None]), pos)
        assert tuple(t_next.shape) == (3, 1)
        _near_tie_equal(t_next.numpy()[:, 0], np.asarray(r_next)[:, 0],
                        np.asarray(r_logits), tol)
        tok = np.array(r_next)[:, 0]


def test_prefill_encdec_matches_reference(ref):
    """``make_prefill_encdec`` on the whisper smoke model with carried
    weights: the reference's greedy tokens (near ties aside) and its
    cross cache within rtol 1e-4 / atol 1e-5."""
    from repro_torch.models.encdec import EncDec
    from repro_torch.serve.step import make_prefill_encdec
    jnp, jax = ref.jnp, ref.jax
    rcfg = importlib.import_module("repro.configs").smoke_config(
        "whisper-base")
    rmodel = importlib.import_module("repro.models.encdec").EncDec(rcfg)
    params = rmodel.init(jax.random.PRNGKey(3))
    cfg = smoke_config("whisper-base")
    port = EncDec(cfg, device="cpu")
    port.load_state_dict(from_reference_params(cfg, params))
    rng = np.random.default_rng(4)
    frames = (0.1 * rng.standard_normal((2, 24, cfg.d_model))
              ).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (2, 7)).astype(np.int32)
    rc, r_tok = ref.step.make_prefill_encdec(rmodel, 12)(
        params, jnp.asarray(frames), jnp.asarray(toks))
    tc, t_tok = make_prefill_encdec(port, 12)(torch.from_numpy(frames),
                                              torch.from_numpy(toks))
    _, r_logits = rmodel.prefill(params, jnp.asarray(frames),
                                 jnp.asarray(toks), 12)
    tol = 2e-4 * float(np.abs(np.asarray(r_logits)).max())
    _near_tie_equal(t_tok.numpy(), np.asarray(r_tok), np.asarray(r_logits),
                    tol)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc["cross"][key].numpy(),
                                   np.asarray(rc["cross"][key]),
                                   rtol=1e-4, atol=1e-5)


def _near_tie_equal(got, want, logits, tol):
    for i in np.nonzero(got != want)[0]:
        assert logits[i, want[i]] - logits[i, got[i]] <= tol, i


# --------------------------------------------------------------------- #
# the examples/pattern_search.py flow
# --------------------------------------------------------------------- #

def _requests(pk_request, vectors, sequences, rng):
    """The example's three request sets (noise from ``rng``): 120
    sampled CONTAINS patterns, 11 boolean/LIKE predicates, and 10 tag +
    range + pattern predicates with the attributes they read."""
    def noisy(p):
        return pk_request(vector=vectors[rng.integers(len(vectors))]
                          + 0.1 * rng.standard_normal(vectors.shape[1]
                                                      ).astype(np.float32),
                          pattern=p, k=10)

    patterns = (sample_patterns(sequences, 2, 40, seed=11)
                + sample_patterns(sequences, 3, 40, seed=11)
                + sample_patterns(sequences, 4, 40, seed=11))
    contains = [noisy(p) for p in patterns]
    p2 = sample_patterns(sequences, 2, 8, seed=23)
    p3 = sample_patterns(sequences, 3, 8, seed=23)
    long_seqs = [s for s in sequences if len(s) >= 8]

    def esc(text):
        return (text.replace("\\", "\\\\").replace("%", r"\%")
                .replace("_", r"\_"))

    predicates = (
        [f"{quote_literal(a)} AND {quote_literal(b)}"
         for a, b in zip(p2[:3], p3[:3])]
        + [f"{quote_literal(a)} OR {quote_literal(b)}"
           for a, b in zip(p3[:3], p3[3:6])]
        + [f"{quote_literal(a)} AND NOT {quote_literal(b)}"
           for a, b in zip(p2[3:5], p3[5:7])]
        + [f"LIKE {quote_literal('%' + esc(s[:3]) + '%' + esc(s[-3:]) + '%')}"
           for s in long_seqs[:3]])
    boolean = [noisy(p) for p in predicates]
    genres = ["rock", "jazz", "pop"]
    attributes = [{"genre": genres[int(rng.integers(0, 3))],
                   "price": float(np.round(rng.uniform(0, 20), 2))}
                  for _ in sequences]
    hybrid = ([f"genre = {quote_literal(g)}" for g in genres]
              + ["price < 5", "price >= 3 AND price <= 12"]
              + [f"{quote_literal(p)} AND genre = 'jazz'" for p in p2[:2]]
              + [f"{quote_literal(p)} AND price < 10" for p in p3[:2]])
    return contains, boolean, [noisy(p) for p in hybrid], attributes


def _flow(Request_, Engine, Config, vectors, sequences, config_kw):
    """Index ``vectors`` and serve the three request sets; returns the
    requests, the engines and every answer."""
    rng = np.random.default_rng(1)
    contains, boolean, hybrid, attributes = _requests(
        Request_, vectors, sequences, rng)
    engine = Engine(vectors, sequences, Config(T=40, M=8, ef_con=50,
                                               **config_kw))
    attr_engine = Engine(vectors, sequences, Config(
        T=40, M=8, ef_con=50, schema={"genre": "tag", "price": "numeric"},
        **config_kw), attributes=attributes)
    answers = (engine.serve_batch(contains) + engine.serve_batch(boolean)
               + attr_engine.serve_batch(hybrid))
    return (contains + boolean + hybrid, engine, attr_engine, attributes,
            answers)


@pytest.fixture(scope="module")
def flow(ref):
    """Both packages run the example: the reference embeds with its LM,
    the port with its ``LM`` carrying the same weights."""
    _, sequences = make_corpus("mtg", scale=SCALE)
    batches = [np.stack([tokenize(s, ref.cfg.vocab_size)
                         for s in sequences[i:i + 16]])
               for i in range(0, len(sequences), 16)]
    r_vecs = ref.engine.embed_texts(ref.model, ref.params, batches
                                    ).astype(np.float32)
    t_vecs = embed_texts(ref.port, batches)
    runs = {
        "ref_numpy": _flow(ref.engine.Request, ref.engine.RetrievalEngine,
                           ref.vm.VectorMatonConfig, r_vecs, sequences, {}),
        "ref_jax": _flow(ref.engine.Request, ref.engine.RetrievalEngine,
                         ref.vm.VectorMatonConfig, r_vecs, sequences,
                         {"backend": "jax"}),
        "port_numpy": _flow(Request, RetrievalEngine, VectorMatonConfig,
                            r_vecs, sequences,
                            {"backend": "numpy", "device": "cpu"}),
        "port_torch": _flow(Request, RetrievalEngine, VectorMatonConfig,
                            r_vecs, sequences,
                            {"backend": "torch", "device": "cpu"}),
    }
    return types.SimpleNamespace(sequences=sequences, r_vecs=r_vecs,
                                 t_vecs=t_vecs, runs=runs)


def test_pattern_search_embeddings_match(flow):
    assert flow.t_vecs.shape == flow.r_vecs.shape
    np.testing.assert_allclose(flow.t_vecs, flow.r_vecs, rtol=1e-4,
                               atol=1e-5)


def _ids(answers):
    return [a.ids.tolist() for a in answers]


def test_pattern_search_answers_match(flow):
    """Host oracle: the port's answers equal the reference's exactly.
    Device path: the port's torch executor equals the reference's JAX
    executor; its graph-free answers equal the host oracle's."""
    ref_np, ref_jax = flow.runs["ref_numpy"], flow.runs["ref_jax"]
    port_np, port_t = flow.runs["port_numpy"], flow.runs["port_torch"]
    assert _ids(port_np[4]) == _ids(ref_np[4])
    for a, b in zip(port_np[4], ref_np[4]):
        np.testing.assert_array_equal(a.distances, b.distances)
    assert _ids(port_t[4]) == _ids(ref_jax[4])
    for a, b in zip(port_t[4], ref_jax[4]):
        np.testing.assert_allclose(a.distances, b.distances, rtol=2e-4,
                                   atol=2e-4)
    engine = port_t[1]
    plan = engine.index.plan([r.pattern for r in port_t[0][:131]])
    graph = {r for e in plan.entries if any(s.graph_states
                                            for s in e.sources)
             for r in e.requests}
    assert graph, "the flow should reach graph states"
    free = [r for r in range(131) if r not in graph]
    for r in free:
        assert port_t[4][r].ids.tolist() == port_np[4][r].ids.tolist(), r


def test_pattern_search_answers_satisfy_predicates(flow):
    """Every id satisfies its request's predicate (attributes included);
    CONTAINS requests reach a high recall@10 against the exact answer."""
    requests, engine, _, attributes, answers = flow.runs["port_torch"]
    seqs = flow.sequences
    for r, (req, resp) in enumerate(zip(requests, answers)):
        pred = parse_predicate(req.pattern)
        attrs = attributes if r >= 131 else None
        for i in resp.ids.tolist():
            assert pred.matches(seqs[i], None if attrs is None
                                else attrs[i]), (req.pattern, i)
    recalls = [recall(resp.ids, ground_truth(
        engine.index.vectors, engine.index.esam, req.pattern, req.vector,
        req.k)) for req, resp in zip(requests[:120], answers[:120])]
    assert np.mean(recalls) >= 0.9, np.mean(recalls)


def test_pattern_search_checkpoint_round_trip(flow, tmp_path):
    requests, engine, _, _, answers = flow.runs["port_torch"]
    engine.checkpoint(str(tmp_path / "engine"))
    restored = RetrievalEngine.restore(str(tmp_path / "engine"),
                                       config=engine.index.config,
                                       device="cpu")
    again = restored.serve_batch(requests[:120])
    assert _ids(again) == _ids(answers[:120])
