"""The traffic is the seed's: the same seed gives the same requests and
documents; every seed offers the same lengths."""

import collections

from gpubench.kinds import ppl, serve
from gpubench.run import load_json, HERE

TRAFFIC = load_json(HERE, "traffic", "serve.json")


def key(recs):
    return [(r.prompt, r.max_new, r.greedy) for r in recs]


def test_same_seed_same_requests():
    a = serve.make_requests(TRAFFIC, 2**31 + 99, 129280, 200)
    b = serve.make_requests(TRAFFIC, 2**31 + 99, 129280, 200)
    c = serve.make_requests(TRAFFIC, 2**31 + 98, 129280, 200)
    assert key(a) == key(b) and key(a) != key(c)
    assert ppl.make_doc(7, 3, 4096, 102400) == ppl.make_doc(7, 3, 4096, 102400)
    assert ppl.make_doc(7, 3, 4096, 102400) != ppl.make_doc(8, 3, 4096, 102400)


def test_every_round_holds_the_mix_once():
    mix = TRAFFIC["mix"]
    for seed in (1, 2**31 + 5):
        recs = serve.make_requests(TRAFFIC, seed, 129280, 3 * mix)
        for r in range(3):
            rnd = recs[r * mix:(r + 1) * mix]
            assert sorted(len(x.prompt) for x in rnd) == sorted(serve.quantile_lengths(64, 512, mix))
            assert sorted(x.max_new for x in rnd) == sorted(serve.quantile_lengths(128, 768, mix))
            assert collections.Counter(x.greedy for x in rnd) == {True: mix // 2, False: mix // 2}
        lens = serve.quantile_lengths(64, 512, mix)
        assert lens[0] >= 64 and lens[-1] <= 512
        assert all(serve.FIRST_ID <= t < 129280 for x in recs for t in x.prompt)
