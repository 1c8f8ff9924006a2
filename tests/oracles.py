"""Pure-numpy oracle implementations of the reference op semantics.

Independent ports (loop-level, readable) of the algorithms implemented by the
reference CUDA/C++ kernels, used as golden references for the XLA/Pallas ops.
Citations point at the kernel whose behavior each oracle encodes.
"""

import numpy as np


def fps_oracle(npoint, xyz):
    """Iterative FPS, seed index 0 (tf_sampling_g.cu:105-170)."""
    B, N, _ = xyz.shape
    idxs = np.zeros((B, npoint), dtype=np.int32)
    for b in range(B):
        mindist = np.full(N, 1e38, dtype=np.float32)
        last = 0
        for j in range(1, npoint):
            d = np.sum((xyz[b] - xyz[b, last]) ** 2, axis=-1).astype(np.float32)
            mindist = np.minimum(mindist, d)
            last = int(np.argmax(mindist))
            idxs[b, j] = last
    return idxs


def query_ball_oracle(radius, nsample, xyz1, xyz2):
    """First-nsample-in-index-order ball query (tf_grouping_g.cu:13-35)."""
    B, N, _ = xyz1.shape
    M = xyz2.shape[1]
    idx = np.zeros((B, M, nsample), dtype=np.int32)
    cnt = np.zeros((B, M), dtype=np.int32)
    for b in range(B):
        for j in range(M):
            c = 0
            for k in range(N):
                if c == nsample:
                    break
                d = max(np.sqrt(np.sum((xyz2[b, j] - xyz1[b, k]) ** 2)), 1e-20)
                if d < radius:
                    if c == 0:
                        idx[b, j, :] = k
                    idx[b, j, c] = k
                    c += 1
            cnt[b, j] = c
    return idx, cnt


def query_ball_oracle_vec(radius, nsample, xyz1, xyz2, block=256):
    """Vectorised :func:`query_ball_oracle`: the same f32 arithmetic
    (``((dx*dx)+(dy*dy))+(dz*dz)``, then ``max(sqrt(d2), 1e-20) < radius``
    in f32) and selection rules, fast enough for the model's live shapes."""
    xyz1 = np.asarray(xyz1, np.float32)
    xyz2 = np.asarray(xyz2, np.float32)
    B, N, _ = xyz1.shape
    M = xyz2.shape[1]
    r = np.float32(radius)
    idx = np.zeros((B, M, nsample), dtype=np.int32)
    cnt = np.zeros((B, M), dtype=np.int32)
    for b in range(B):
        for m0 in range(0, M, block):
            q = xyz2[b, m0 : m0 + block]
            dx = q[:, None, 0] - xyz1[b, None, :, 0]
            dy = q[:, None, 1] - xyz1[b, None, :, 1]
            dz = q[:, None, 2] - xyz1[b, None, :, 2]
            d2 = (dx * dx + dy * dy) + dz * dz
            hit = np.maximum(np.sqrt(d2), np.float32(1e-20)) < r
            rank = np.cumsum(hit, axis=1)
            rows, cols = np.nonzero(hit & (rank <= nsample))
            c = np.minimum(hit.sum(axis=1), nsample).astype(np.int32)
            blk = np.zeros((len(q), nsample), np.int32)
            blk[rows, rank[rows, cols] - 1] = cols
            slot = np.arange(nsample)[None, :]
            blk = np.where(slot < c[:, None], blk, blk[:, :1])
            idx[b, m0 : m0 + block] = blk
            cnt[b, m0 : m0 + block] = c
    return idx, cnt


def group_point_oracle(points, idx):
    """Feature gather (tf_grouping_g.cu:40-57)."""
    B, M, S = idx.shape
    C = points.shape[-1]
    out = np.zeros((B, M, S, C), dtype=points.dtype)
    for b in range(B):
        out[b] = points[b][idx[b]]
    return out


def three_nn_oracle(xyz1, xyz2):
    """Brute-force 3-NN with squared distances (tf_interpolate.cpp:60-103)."""
    B, N, _ = xyz1.shape
    M = xyz2.shape[1]
    dist = np.zeros((B, N, 3), dtype=np.float32)
    idx = np.zeros((B, N, 3), dtype=np.int32)
    for b in range(B):
        d2 = np.sum((xyz1[b][:, None] - xyz2[b][None]) ** 2, axis=-1)  # (N, M)
        order = np.argsort(d2, axis=-1, kind="stable")[:, :3]
        idx[b] = order
        dist[b] = np.take_along_axis(d2, order, axis=-1)
    return dist, idx


def three_interpolate_oracle(points, idx, weight):
    """Weighted 3-neighbor sum (tf_interpolate.cpp:107-127)."""
    B, N, _ = idx.shape
    out = np.zeros((B, N, points.shape[-1]), dtype=points.dtype)
    for b in range(B):
        for n in range(N):
            for j in range(3):
                out[b, n] += weight[b, n, j] * points[b, idx[b, n, j]]
    return out


def _signed_area(poly):
    x = np.array([p[0] for p in poly])
    y = np.array([p[1] for p in poly])
    return 0.5 * np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)


def _clip_area(subject, clip):
    """Sutherland–Hodgman convex clip; returns |intersection area|."""
    subject = [np.asarray(p, float) for p in subject]
    clip = [np.asarray(p, float) for p in clip]
    if _signed_area(clip) < 0:
        clip = clip[::-1]
    out = list(subject)
    for i in range(len(clip)):
        if not out:
            return 0.0
        a, b = clip[i], clip[(i + 1) % len(clip)]
        e = b - a
        inp, out = out, []
        for j in range(len(inp)):
            p, q = inp[j], inp[(j + 1) % len(inp)]
            pin = e[0] * (p[1] - a[1]) - e[1] * (p[0] - a[0]) >= 0
            qin = e[0] * (q[1] - a[1]) - e[1] * (q[0] - a[0]) >= 0
            if pin:
                out.append(p)
            if pin != qin:
                d = q - p
                denom = e[0] * d[1] - e[1] * d[0]
                t = (e[0] * (a[1] - p[1]) - e[1] * (a[0] - p[0])) / denom
                out.append(p + t * d)
    if len(out) < 3:
        return 0.0
    return abs(_signed_area(out))


def shapely_iou3d(bbox1, bbox2):
    """The eval-path IoU semantics (evaluator.py:26-39): exact top-face
    polygon intersection times y-overlap over union volume. Shapely isn't in
    this environment; a Sutherland–Hodgman convex clip computes the same
    exact area."""
    assert bbox1[0, 1] > bbox1[4, 1] and bbox2[0, 1] > bbox2[4, 1]
    poly1 = np.stack([bbox1[:4, 0], bbox1[:4, 2]], -1)
    poly2 = np.stack([bbox2[:4, 0], bbox2[:4, 2]], -1)
    a1, a2 = abs(_signed_area(poly1)), abs(_signed_area(poly2))
    inter_area = _clip_area(poly1, poly2)
    inter_vol = inter_area * max(
        0.0, min(bbox1[0, 1], bbox2[0, 1]) - max(bbox1[4, 1], bbox2[4, 1])
    )
    return inter_vol / (
        a1 * (bbox1[0, 1] - bbox1[4, 1])
        + a2 * (bbox2[0, 1] - bbox2[4, 1])
        - inter_vol
    )


def nms3d_oracle(corners, scores, objectness, iou_threshold):
    """Greedy same-batch NMS keep mask (tf_nms3d.cpp:202-264)."""
    B, N = scores.shape
    keep = np.zeros((B, N), dtype=bool)
    for b in range(B):
        cand = objectness[b, :, 1] > objectness[b, :, 0]
        order = np.argsort(-scores[b], kind="stable")
        selected = []
        for i in order:
            if not cand[i]:
                continue
            ok = True
            for j in selected:
                if shapely_iou3d(corners[b, i], corners[b, j]) > iou_threshold:
                    ok = False
                    break
            if ok:
                selected.append(i)
                keep[b, i] = True
    return keep


def random_boxes(rng, shape):
    """Random well-formed boxes -> corners (..., 8, 3) for IoU/NMS tests."""
    from votenet_tpu.data.geometry import box_corners_votenet

    size = rng.uniform(0.3, 2.0, shape + (3,))
    heading = rng.uniform(0, 2 * np.pi, shape)
    center = rng.uniform(-2, 2, shape + (3,))
    return box_corners_votenet(size, heading, center).astype(np.float32)
