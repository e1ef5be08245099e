"""Adversarial matcher states for the fused match-and-update step (kernel
B3's ``match_update``), made with numpy from a seed.  Shared by the CPU
tests against the JAX package and the card tests; imports neither.

Boxes lie on a grid of 1/64, so every IoU is computed exactly up to its one
rounded division, whichever operations a backend fuses.  Each rule of the
step gets a detection of its own, with a box of one grid cell at a cell no
other role uses: such a box overlaps a random ring box (4 to 19 cells a
side) by an IoU of at most 1/16, so the roles do not disturb one another.
The roles, as far as D and R leave room, in this order:
- ``tie``: one box at slots lo - 1 and lo of a block boundary of a cluster
  of 2, 3 or 8 blocks (the lower slot must win);
- ``cross``: a seen-once entry from another chunk (1 -> 2, crossed);
- ``double``: two detections on one seen-once entry of this chunk (1 -> 3);
- ``thresh``: a detection whose best IoU is exactly 0.5;
- ``gate_in``/``gate_out``: entries at |Δframe| = time_gate and
  time_gate + 1;
- ``video``: an entry of another video;
- ``empty``: an empty slot (times_seen 0) that would otherwise match;
- ``invalid``: an invalid detection on a live entry;
- ``wrap``: a seen-once entry at slot 0, matched, with the cursor at R - 2,
  so that the third insert overwrites it in the same frame;
then random detections, mostly new.
"""
from __future__ import annotations

import numpy as np

GRID = 64
VIDEO, FRAME, CHUNK = 3, 5000, 7
BOUNDARY_BLOCKS = (2, 3, 8)
FIELDS = ("boxes", "feats", "video", "frame", "chunk", "times_seen", "cursor", "total_inserted")


def _random_boxes(rng, n):
    xy = rng.integers(0, 40, (n, 2))
    wh = rng.integers(4, 20, (n, 2))
    return (np.concatenate([xy, xy + wh], axis=1) / GRID).astype(np.float32)


def frame_case(seed: int, d: int, r: int, *, f: int = 8, time_gate: int = 900, all_invalid: bool = False,
               frame_id: int = FRAME) -> dict:
    """One ring of ``r`` slots and one frame of ``d`` detections (numpy),
    with ``roles``: role -> (slots, detections) it placed."""
    rng = np.random.default_rng(seed)
    seen = rng.choice(np.array([0, 1, 1, 1, 2, 3], np.int32), r)
    ring = dict(
        boxes=_random_boxes(rng, r),
        feats=rng.standard_normal((r, f)).astype(np.float32),
        video=np.where(rng.random(r) < 0.1, VIDEO + 1, VIDEO).astype(np.int32),
        frame=(frame_id + rng.integers(-time_gate - 3, time_gate + 4, r)).astype(np.int32),
        chunk=rng.choice(np.array([CHUNK, CHUNK, CHUNK - 1, CHUNK + 1], np.int32), r),
        times_seen=seen,
    )
    # half the empty slots as init_matcher leaves them, half with stale data
    init = (seen == 0) & (rng.random(r) < 0.5)
    ring["boxes"][init] = 0.0
    ring["feats"][init] = 0.0
    ring["video"][init], ring["frame"][init], ring["chunk"][init] = -1, -(10**9), -1
    cursor = int(rng.integers(0, r))
    ring["cursor"] = np.int32(cursor)
    ring["total_inserted"] = np.int32(cursor + r * int(rng.integers(0, 3)))
    det = dict(boxes=_random_boxes(rng, d), feats=rng.standard_normal((d, f)).astype(np.float32),
               valid=rng.random(d) < 0.9)

    cells = iter(rng.permutation(GRID * GRID))
    taken, roles, used = set(), {}, [0]

    def cell():
        c = next(cells)
        x, y = divmod(int(c), GRID)
        return np.array([x, y, x + 1, y + 1], np.float32) / GRID

    def live(s, box, *, seen_=1, video=VIDEO, frame=frame_id, chunk=CHUNK):
        taken.add(s)
        ring["boxes"][s], ring["times_seen"][s] = box, seen_
        ring["video"][s], ring["frame"][s], ring["chunk"][s] = video, frame, chunk

    def dets(role, slots, *boxes, valid=True):
        if used[0] + len(boxes) > d or any(s in taken or not 0 <= s < r for s in slots):
            return False
        idx = list(range(used[0], used[0] + len(boxes)))
        for i, box in zip(idx, boxes):
            det["boxes"][i], det["valid"][i] = box, valid
        used[0] += len(boxes)
        roles.setdefault(role, []).append((list(slots), idx))
        return True

    for blocks in BOUNDARY_BLOCKS:
        lo = -(-r // blocks)
        box = cell()
        if lo < r and dets("tie", (lo - 1, lo), box):
            live(lo - 1, box, seen_=int(rng.integers(1, 3)))
            live(lo, box, seen_=int(rng.integers(1, 3)))
    free = (s for s in rng.permutation(np.arange(1, r)) if s not in taken)
    if r > 1 and not all_invalid:
        ring["cursor"] = np.int32(r - 2)
        box = cell()
        if dets("wrap", (0,), box):
            live(0, box, seen_=1)
    for role in ("cross", "double", "thresh", "gate_in", "gate_out", "video", "empty", "invalid"):
        s = next(free, None)
        if s is None:
            break
        box = cell()
        if role == "thresh":
            x, y = rng.integers(0, 32, 2) / GRID
            box = np.array([x, y, x + 0.5, y + 0.5], np.float32)    # IoU 0.125 / 0.25 with its entry
            if dets(role, (s,), box):
                live(s, np.array([x, y, x + 0.5, y + 0.25], np.float32))
            continue
        if not dets(role, (s,), *([box, box] if role == "double" else [box]), valid=role != "invalid"):
            continue
        kw = dict(cross=dict(chunk=CHUNK - 1), gate_in=dict(frame=frame_id + time_gate),
                  gate_out=dict(frame=frame_id - time_gate - 1), video=dict(video=VIDEO + 1),
                  empty=dict(seen_=0)).get(role, {})
        live(s, box, **kw)
    for i in range(used[0], d):
        det["boxes"][i] = cell()                                      # new unless invalid
    if all_invalid:
        det["valid"][:] = False
    return dict(ring=ring, det=det, ids=(VIDEO, frame_id, CHUNK), time_gate=time_gate, roles=roles)


def batch_case(seed: int, q: int, d: int, r: int, **kw) -> dict:
    """``q`` frame cases stacked along a leading axis; the last query's
    detections are all invalid (a query that is no longer active)."""
    cases = [frame_case(seed + i, d, r, frame_id=FRAME + 37 * i, all_invalid=(i == q - 1 and q > 1), **kw)
             for i in range(q)]
    return dict(
        ring={k: np.stack([c["ring"][k] for c in cases]) for k in FIELDS},
        det={k: np.stack([c["det"][k] for c in cases]) for k in ("boxes", "feats", "valid")},
        ids=tuple(np.array([c["ids"][j] for c in cases], np.int64) for j in range(3)),
        time_gate=cases[0]["time_gate"], cases=cases)
