"""The port's ``ContinuousBatcher`` against ``repro.serving.scheduler`` (CPU).

Both batchers serve the same requests (prompts from numpy seeds, weights
carried by ``transformer_from_numpy``): served counts, generated tokens,
decode steps and occupancy are equal, and the greedy tokens are equal
wherever the reference's top-2 logit gap exceeds 1e-4, the float32
tolerance of the logits. At a position whose gap is within it, the two
may pick different tokens and part ways from there on; that position
is checked to be such a near-tie, and the request is compared no
further.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.serving import scheduler as RS  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import scheduler as TS  # noqa: E402

GAP_TOL = 1e-4  # float32 logits agree within it (test_torch_transformer)
CASES = [
    # (arch, max_batch, max_len, prompt lengths, new tokens)
    ("smollm-135m", 4, 32, [5] * 7, 4),  # test_batcher_serves_all_requests
    ("olmoe-1b-7b", 3, 24, [3, 9, 4, 6, 2, 8, 5], 6),
]


def _requests(mod, vocab, lengths, new, seed=0):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, prompt=rng.integers(0, vocab, n).astype(
        np.int32), max_new_tokens=new) for i, n in enumerate(lengths)]


def _serve(batcher, reqs):
    for r in reqs:
        batcher.submit(r)
    return batcher.run()


def _top2_gap(fwd, params, tokens) -> float:
    logits = np.asarray(fwd(params, jnp.asarray(np.asarray(tokens)[None])))
    top = np.sort(logits[0, -1])[-2:]
    return float(top[1] - top[0])


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def served(request):
    arch, max_batch, max_len, lengths, new = request.param
    cfg = jax_smoke(arch)
    params = RT.init_params(jax.random.PRNGKey(0), cfg)
    tcfg = get_smoke_config(arch)
    tp = TT.transformer_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                   tcfg, device="cpu")
    ref_reqs = _requests(RS, cfg.vocab_size, lengths, new)
    ref_stats = _serve(RS.ContinuousBatcher(cfg, params, max_batch, max_len),
                       ref_reqs)
    reqs = _requests(TS, cfg.vocab_size, lengths, new)
    batcher = TS.ContinuousBatcher(tcfg, tp, max_batch, max_len)
    stats = _serve(batcher, reqs)
    fwd = jax.jit(lambda p, t: RT.forward(p, cfg, None, {"tokens": t}))
    return dict(cfg=tcfg, tp=tp, max_batch=max_batch, max_len=max_len,
                params=params, fwd=fwd, ref=(ref_reqs, ref_stats),
                got=(reqs, stats), batcher=batcher, lengths=lengths, new=new)


def test_stats_equal_reference(served):
    ref_stats, stats = served["ref"][1], served["got"][1]
    assert stats.served == ref_stats.served == len(served["lengths"])
    assert stats.generated_tokens == ref_stats.generated_tokens
    assert stats.decode_steps == ref_stats.decode_steps
    assert stats.mean_occupancy == pytest.approx(ref_stats.mean_occupancy,
                                                 abs=1e-12)
    assert 0 < stats.mean_occupancy <= 1.0
    assert not served["batcher"].queue and not served["batcher"].active


def test_greedy_tokens_equal_up_to_near_ties(served):
    compared = 0
    for ref, got in zip(*(r for r, _ in (served["ref"], served["got"]))):
        assert len(got.output) == len(ref.output) == served["new"]
        assert got.finished_at is not None
        for j, (a, b) in enumerate(zip(got.output, ref.output)):
            if a != b:  # allowed only where the reference was a near-tie
                prefix = list(ref.prompt) + ref.output[:j]
                gap = _top2_gap(served["fwd"], served["params"], prefix)
                assert gap <= GAP_TOL, (ref.rid, j, gap)
                break
            compared += 1
    assert compared >= len(served["lengths"]) * served["new"] // 2


def test_outputs_deterministic(served):
    reqs = _requests(TS, served["cfg"].vocab_size, served["lengths"],
                     served["new"])
    _serve(TS.ContinuousBatcher(served["cfg"], served["tp"],
                                served["max_batch"], served["max_len"]), reqs)
    assert [r.output for r in reqs] == [r.output for r in served["got"][0]]


def test_max_len_ends_a_request():
    cfg = get_smoke_config("smollm-135m")
    tp = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batcher = TS.ContinuousBatcher(cfg, tp, max_batch=2, max_len=8)
    req = TS.Request(rid=0, prompt=np.arange(5, dtype=np.int32),
                     max_new_tokens=10)
    stats = _serve(batcher, [req])
    # slot_pos + 1 reaches max_len after 7 fed tokens: 5 prompt + 2 generated
    assert stats.served == 1 and len(req.output) == 3
    assert stats.decode_steps == 7


def test_batcher_rejects_a_dist_context():
    """A ``dist`` that is not a DistContext is refused; a DistContext is
    taken (``tests/test_torch_dist_context.py`` serves through one)."""
    from repro_torch.distributed.context import make_context
    from repro_torch.launch.mesh import make_mesh

    cfg = get_smoke_config("smollm-135m")
    tp = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(TypeError, match="DistContext"):
        TS.ContinuousBatcher(cfg, tp, 2, 8, dist=object())
    dist = make_context(make_mesh((2, 4), ("data", "model")))
    assert TS.ContinuousBatcher(cfg, tp, 2, 8, dist=dist).dist is dist
