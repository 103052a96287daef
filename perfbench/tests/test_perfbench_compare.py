"""The compared numbers: each row's cosine gap to the reference's, their
largest and their mean, and each number held to its limit."""

import numpy as np
import pytest

from perfbench import compare


def test_cosine_gaps():
    ref = np.eye(3, 4, dtype=np.float32)
    got = 2 * ref  # a row's scale is not a gap
    got[1] = [0.0, 1.0, 1.0, 0.0]  # 45 degrees off
    out = compare.numbers(got, ref)
    assert out["cos_gap_max"] == pytest.approx(1 - 2 ** -0.5)
    assert out["cos_gap_mean"] == pytest.approx((1 - 2 ** -0.5) / 3)
    got[2] = np.nan
    assert compare.numbers(got, ref)["cos_gap_max"] == np.inf


def test_judge_holds_each_number_to_its_limit():
    limits = {"compare": {"cos_gap_mean": 1e-4, "cos_gap_max": 2e-4}}
    ok = compare.judge({"cos_gap_mean": 5e-5, "cos_gap_max": 1e-4,
                        "emb_err_max": 1.0}, limits)
    assert set(ok) == {"cos_gap_mean", "cos_gap_max"}
    assert compare.passed(ok)
    assert not compare.passed(compare.judge(
        {"cos_gap_mean": 5e-5, "cos_gap_max": 3e-4}, limits))
