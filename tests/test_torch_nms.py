"""NMS in the port (ops/nms.py, native/nms.cpp) against the reference
package's masked NMS and C++ host NMS and the greedy oracle of
tests/test_nms.py: keep-lists equal, with tied scores (a stable order keeps
ties in index order), exact-threshold overlaps (+1-inclusive areas,
suppression at IoU >= thresh) and empty input included."""

import numpy as np
import pytest
import torch
from test_nms import oracle_nms, random_dets

from dfanerf_tpu.ops.nms import iou_matrix as j_iou
from dfanerf_tpu.ops.nms import nms as j_nms
from dfanerf_tpu.ops.nms import nms_native as j_nms_native
from dfanerf_torch.ops.nms import iou_matrix, nms, nms_mask, nms_native


def tied_dets(rng, n):
    """random_dets with scores drawn from a few levels, so most are tied."""
    dets = random_dets(rng, n)
    dets[:, 4] = rng.randint(0, 4, n) / 4.0
    return dets


@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7])
@pytest.mark.parametrize("make", [random_dets, tied_dets], ids=["random", "tied"])
def test_keep_lists_equal(thresh, make):
    rng = np.random.RandomState(int(thresh * 10))
    for n in (1, 7, 40, 300):
        dets = make(rng, n)
        want = oracle_nms(dets, thresh)
        assert nms(dets, thresh) == want
        assert nms(torch.from_numpy(dets), thresh) == want
        assert nms_native(dets, thresh) == want
        assert j_nms(dets, thresh) == j_nms_native(dets, thresh) == want


def test_iou_matrix_equal():
    dets = random_dets(np.random.RandomState(3), 50)
    np.testing.assert_array_equal(iou_matrix(torch.from_numpy(dets[:, :4])).numpy(),
                                  np.asarray(j_iou(dets[:, :4])))


def test_edge_cases():
    empty = np.zeros((0, 5), np.float32)
    assert nms(empty, 0.5) == nms_native(empty, 0.5) == j_nms_native(empty, 0.5) == []
    assert nms_mask(torch.from_numpy(empty), 0.5).shape == (0,)
    # identical boxes, identical scores: the first index alone survives
    same = np.tile(np.array([[0, 0, 10, 10, 0.9]], np.float32), (5, 1))
    assert nms(same, 0.5) == nms_native(same, 0.5) == j_nms(same, 0.5) == [0]
    # IoU exactly at the threshold suppresses: with +1-inclusive areas the
    # boxes cover 11x11 and 11x22 pixels, the first inside the second, IoU 0.5
    a = np.array([[0, 0, 10, 10, 0.9], [0, 0, 10, 21, 0.8]], np.float32)
    iou = float(iou_matrix(torch.from_numpy(a[:, :4]))[0, 1])
    assert iou == 0.5
    assert nms(a, iou) == nms_native(a, iou) == j_nms(a, iou) == oracle_nms(a, iou) == [0]
    assert nms(a, np.nextafter(np.float32(iou), np.float32(1))) == [0, 1]
