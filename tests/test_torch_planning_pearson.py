"""The Pearson half of the ``fleet_plan`` parity grid (the comparison and
its tolerance classes are in ``test_torch_planning.py``)."""
import itertools

import pytest
import torch

from test_torch_planning import check_fleet_plan

# one intra-op thread: the suite runs several pytest workers on the
# host's cores, and a torch thread pool in each oversubscribes them
torch.set_num_threads(1)

GRID = list(itertools.product(("pearson",), ("linear", "cubic"),
                              ("k_se", "alpha", "exact_mse"), (False, True)))


@pytest.mark.parametrize("dependence,model,policy,use_kernel", GRID,
                         ids=["-".join(map(str, g)) for g in GRID])
def test_fleet_plan_matches_reference_pearson(dependence, model, policy,
                                              use_kernel):
    check_fleet_plan(dependence, model, policy, use_kernel)
