"""The port's SAA-Gs (``repro_torch.baselines.saa_gs``) against the
reference's on the CPU: both sampling budgets (``log n`` and linear) at two
seeds give the reference's partition, and metrics to rtol 1e-12."""

from __future__ import annotations

import pytest
import torch

from repro.baselines import saa_gs as rsaa

from repro_torch.baselines import summarize_saa_gs

from test_torch_baselines import assert_same_result, graph

torch.set_num_threads(1)


@pytest.mark.parametrize("linear_sample", [False, True])
@pytest.mark.parametrize("seed", [0, 3])
def test_saa_gs_partition_equals_the_reference(seed, linear_sample):
    src, dst, v = graph()
    assert_same_result(
        summarize_saa_gs(src, dst, v, 0.3, linear_sample=linear_sample, seed=seed,
                         device="cpu"),
        rsaa.summarize_saa_gs(src, dst, v, 0.3, linear_sample=linear_sample, seed=seed))
