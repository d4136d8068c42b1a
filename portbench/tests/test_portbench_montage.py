"""The Montage backlog generator: stage widths, dependencies, length
laws, and the same sizes for every seed."""
from collections import Counter

import numpy as np
import smoke  # noqa: F401  (puts the benchmark on the path)

import harness
from gen import montage, serve_backlog


def test_template_stage_widths_and_deps():
    t = montage.template(8)
    widths = Counter(montage.STAGES[s] for s in t.stage)
    assert widths == {"mProjectPP": 8, "mDiffFit": 30, "mConcatFit": 1,
                      "mBgModel": 1, "mBackground": 8, "mImgtbl": 1,
                      "mAdd": 1, "mShrink": 1, "mJPEG": 1}
    for i, dd in enumerate(t.deps):
        assert all(t.stage[d] < t.stage[i] for d in dd)
        assert (len(dd) == 0) == (t.stage[i] == 0)
    concat = t.stage.index(2)
    assert len(t.deps[concat]) == 30
    # every mBackground waits for mBgModel and its own projection
    for i in (i for i, s in enumerate(t.stage) if s == 4):
        assert sorted(t.stage[d] for d in t.deps[i]) == [0, 3]


def test_pool_length_laws():
    traffic = harness.load_json(harness.HERE / "traffic"
                                / "montage-backlog.json")
    t = montage.template(traffic["n_project"])
    prompt, out = serve_backlog.draw_pool(traffic, t, 2048)
    assert prompt.shape == out.shape == (traffic["pool_workflows"], 52)
    assert prompt.min() >= 32 and prompt.max() <= 1536
    assert 200 < np.median(prompt) < 320
    assert (prompt + out <= 2048).all() and out.min() >= 1
    par = np.array([r is None for r in t.runtime])
    assert 60 <= np.median(out[:, par]) <= 72          # 6 x 11 s
    serial = {s: 6 * r for s, r in montage.SERIAL_RUNTIME.items()}
    for i, r in enumerate(t.runtime):
        if r is not None:
            name = montage.STAGES[t.stage[i]]
            assert (out[:, i] <= serial[name]).all()
            assert np.median(out[:, i]) == serial[name]


def backlog(seed, **kw):
    traffic = harness.load_json(harness.HERE / "traffic"
                                / "montage-backlog.json")
    return serve_backlog.Backlog(traffic, seed,
                                 max_batch=kw.get("max_batch", 8),
                                 max_len=2048,
                                 n_codebooks=kw.get("ncb", 1), vocab=100)


def test_backlog_releases_children_and_tops_up():
    # the first workflows start at staggered stages
    stages = {t.stage for t in backlog(5, max_batch=64).ready}
    assert set(montage.STAGES) == stages
    b = backlog(5)
    assert len(b.ready) >= 16
    served = 0
    while served < 400:
        for t in b.take(4, 10**6):
            assert t.prompt.shape == (len(t.prompt),)
            assert (0 <= t.prompt).all() and (t.prompt < 100).all()
            b.done(t)
            served += 1
        assert len(b.ready) >= 16


def test_same_sizes_every_seed_in_another_order():
    a, b = backlog(1), backlog(2**31 + 7)
    sizes = lambda bl: sorted(  # noqa: E731
        (len(t.prompt), t.max_new) for t in bl.take(10**6, 10**9))
    assert a.pool[0].tolist() == b.pool[0].tolist()
    assert sizes(backlog(3)) == sizes(backlog(3))
    x, y = backlog(1), backlog(2)
    assert [len(t.prompt) for t in x.take(20, 10**6)] != \
        [len(t.prompt) for t in y.take(20, 10**6)]


def test_codebook_prompts():
    t = backlog(9, ncb=4).take(1, 10**6)[0]
    assert t.prompt.shape[1] == 4 and t.prompt.dtype == np.int32


def test_children_wait_for_every_parent():
    b = backlog(11)
    staggered = b.n_workflows       # started past their first stages
    done, n = set(), 0
    while n < 3000:
        for t in b.take(3, 10**6):
            if t.workflow >= staggered:
                assert all((t.workflow, d) in done
                           for d in b.tmpl.deps[t.index])
            done.add((t.workflow, t.index))
            n += 1
            b.done(t)
    # whole workflows ran through to mJPEG
    assert any(montage.STAGES[b.tmpl.stage[i]] == "mJPEG"
               for w, i in done if w >= staggered)


def test_take_keeps_to_the_prefill_budget_in_order():
    b = backlog(13)
    head = [len(t.prompt) for t in list(b.ready)[:40]]
    got = [len(t.prompt) for t in b.take(40, 1536)]
    assert got == head[:len(got)]
    assert sum(got) <= 1536 or len(got) == 1
    assert len(got) == 40 or sum(head[:len(got) + 1]) > 1536
    assert len(b.take(40, 1)) == 1          # the first always goes
