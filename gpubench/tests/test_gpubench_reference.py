"""The reference's routing: its own top-k, and the program's choice taken
only where it differs by a tie."""

import torch

from gpubench.reference.forward import TIE, route

HF = {"num_experts_per_tok": 2, "topk_method": "noaux_tc", "n_group": 2, "topk_group": 1,
      "norm_topk_prob": True, "routed_scaling_factor": 2.5}


def test_own_choice_and_ties():
    scores = torch.tensor([[0.9, 0.5, 0.5 - TIE / 2, 0.1, 0.2, 0.3, 0.1, 0.0],
                           [0.9, 0.5, 0.3, 0.1, 0.2, 0.3, 0.1, 0.0]])
    w, idx, taken, refused = route(scores, HF, None)
    assert idx.sort(-1).values.tolist() == [[0, 1], [0, 1]]
    assert torch.allclose(w.sum(-1), torch.full((2,), 2.5))
    given = torch.tensor([[0, 2], [0, 2]])          # a tie in row 0, a wrong choice in row 1
    _, idx, taken, refused = route(scores, HF, None, given)
    assert taken.tolist() == [True, False] and refused.tolist() == [False, True]
    assert idx[0].tolist() == [0, 2] and idx[1].sort().values.tolist() == [0, 1]
    _, idx, taken, refused = route(scores, HF, None, torch.full((2, 2), -1))
    assert not taken.any() and not refused.any()
    # an expert of the group the reference left out is no tie
    _, _, taken, refused = route(scores, HF, None, torch.tensor([[0, 5], [0, 1]]))
    assert refused.tolist() == [True, False]


def test_a_tie_between_groups_takes_the_other_groups_top_k():
    """Groups tied within TIE: the program's pick of the other group is
    taken when its experts are that group's top-k, refused otherwise."""
    hf = dict(HF, topk_group=1)
    scores = torch.tensor([[0.6, 0.3, 0.1, 0.0, 0.5, 0.4 - TIE / 4, 0.05, 0.0]])
    assert route(scores, hf, None)[1].sort().values.tolist() == [[0, 1]]
    _, idx, taken, refused = route(scores, hf, None, torch.tensor([[4, 5]]))
    assert taken.tolist() == [True] and idx.tolist() == [[4, 5]]
    _, idx, taken, refused = route(scores, hf, None, torch.tensor([[4, 6]]))
    assert refused.tolist() == [True] and idx.sort().values.tolist() == [[0, 1]]


def test_a_kept_group_that_gave_no_expert_is_tried_each_way():
    """The program kept group 2 (tied with group 1 within TIE) and took
    both experts of group 0: a tie, although filling its groups with the
    reference's own second group would make expert 2 its choice."""
    hf = dict(HF, n_group=4, topk_group=2)
    scores = torch.tensor([[0.9, 0.5, 0.6, 0.3, 0.45, 0.45 - TIE / 4, 0.1, 0.0]])
    assert route(scores, hf, None)[1].sort().values.tolist() == [[0, 2]]
    _, idx, taken, refused = route(scores, hf, None, torch.tensor([[0, 1]]))
    assert taken.tolist() == [True] and idx.tolist() == [[0, 1]]
    # group 3 is no tie with group 1: taking it is refused
    _, _, taken, refused = route(scores, hf, None, torch.tensor([[0, 6]]))
    assert refused.tolist() == [True]


def test_leaving_out_a_better_expert_is_no_tie():
    """The given set's lowest score is within TIE of the reference's k-th,
    but it leaves out the best expert: refused."""
    hf = dict(HF, topk_method="greedy")
    scores = torch.tensor([[0.9, 0.5, 0.5 - TIE / 2, 0.1]])
    _, _, taken, refused = route(scores, hf, None, torch.tensor([[1, 2]]))
    assert refused.tolist() == [True]
    _, _, taken, refused = route(scores, hf, None, torch.tensor([[0, 2]]))
    assert taken.tolist() == [True]
