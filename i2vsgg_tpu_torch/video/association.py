"""Stage C (part 1): temporal association of per-frame relation detections —
a copy of ``i2vsgg_tpu/video/association.py`` (numpy only; the port keeps
its own copy rather than importing the JAX package).

Host-side rebuild of the reference's association pipeline
(``lib/utils.py:37-98, 134-182, 461-526``). The JSON schemas are kept
byte-compatible (keys ``triplet/score/duration/sub_traj/obj_traj/rel_idex``)
so outputs interoperate with reference dumps. Differences (deliberate):

* class/predicate name lists are explicit arguments instead of import-time
  loads of hardcoded absolute paths (reference defect SURVEY.md §8.4).
* pure Python/numpy — this stays host code by design; the per-frame device
  program produces the (conf, triplet, boxes) tuples.

Data shapes:
  frame_relations[vid] = list of [frame_index, pred_list]
  pred_list item       = [conf, [s_cid, pid, o_cid],
                          [sub_box, obj_box], rel_index]
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def _iou(b1, b2) -> float:
    """Association-time IoU, the reference's EXACT form
    [lib/utils.py:20-31]: NO +1 pixel convention (unlike detection-eval
    IoU and vIoU, which do use +1) and 0 on degenerate overlap. The +1
    form is more permissive near the 0.5 both_overlap threshold and was
    measurably changing merge decisions (caught by
    tests/test_parity_stage_c.py's golden A/B)."""
    left, top = max(b1[0], b2[0]), max(b1[1], b2[1])
    right, bottom = min(b1[2], b2[2]), min(b1[3], b2[3])
    if left >= right or bottom <= top:
        return 0.0
    inter = (right - left) * (bottom - top)
    a1 = (b1[2] - b1[0]) * (b1[3] - b1[1])
    a2 = (b2[2] - b2[0]) * (b2[3] - b2[1])
    return inter / (a1 + a2 - inter)


class VideoRelation:
    """Video-level relation instance. [lib/utils.py:37-98]"""

    def __init__(self, s_cid, pid, o_cid, straj, otraj, fstart,
                 confs=1.0, idex=0, objects: Sequence[str] = (),
                 predicates: Sequence[str] = ()):
        self.s_cid = int(s_cid)
        self.pid = int(pid)
        self.o_cid = int(o_cid)
        self.rel_idex_list = [idex]
        self.straj = list(straj)
        self.otraj = list(otraj)
        self.confs_list = [confs]
        self.fstart = fstart
        self.fend = fstart + 1
        self.objects = objects
        self.predicates = predicates

    def triplet(self) -> List[int]:
        return [self.s_cid, self.pid, self.o_cid]

    def mean_confs(self) -> float:
        return float(np.mean(self.confs_list))

    def both_overlap(self, straj, otraj, iou_thr: float = 0.5) -> bool:
        return (_iou(self.straj[-1], straj[0]) >= iou_thr
                and _iou(self.otraj[-1], otraj[0]) >= iou_thr)

    def extend(self, straj, otraj, confs, idex) -> None:
        self.straj.extend(straj)
        self.otraj.extend(otraj)
        self.confs_list.append(confs)
        self.rel_idex_list.append(idex)
        self.fend += 1

    def serialize(self) -> Dict:
        name = lambda lst, i: (lst[i] if i < len(lst) else int(i))
        return {
            "triplet": [name(self.objects, self.s_cid),
                        name(self.predicates, self.pid),
                        name(self.objects, self.o_cid)],
            "score": self.mean_confs(),
            "duration": [int(self.fstart), int(self.fend)],
            "sub_traj": [list(map(float, b)) for b in self.straj],
            "obj_traj": [list(map(float, b)) for b in self.otraj],
            "rel_idex": self.rel_idex_list,
        }


def greedy_relational_association(frame_relations,
                                  max_traj_num_in_clip: int = 100,
                                  min_length: int = 10,
                                  objects: Sequence[str] = (),
                                  predicates: Sequence[str] = ()) -> List[Dict]:
    """Greedy frame-to-frame linking. [lib/utils.py:134-182]

    Links same-triplet detections in consecutive frames when both subject and
    object boxes overlap (IoU >= 0.5); keeps trajectories of length >=
    ``min_length``.
    """
    frame_relations = sorted(frame_relations, key=lambda x: int(x[0]))
    video_relation_list: List[VideoRelation] = []
    last_active: List[VideoRelation] = []
    for i, (index, pred_list) in enumerate(frame_relations):
        fstart = index
        preds = sorted(pred_list, key=lambda x: x[0],
                       reverse=True)[:max_traj_num_in_clip]
        cur_active: List[VideoRelation] = []
        for pred in preds:
            conf, (s_cid, pid, o_cid), (sbox, obox), rel_idex = \
                pred[0], pred[1], pred[2], pred[3]
            straj, otraj = [sbox], [obox]
            merged = False
            if i > 0:
                last_active.sort(key=lambda r: r.mean_confs(), reverse=True)
                for r in last_active:
                    if (list(pred[1]) == r.triplet() and fstart == r.fend
                            and r.both_overlap(straj, otraj)):
                        r.extend(straj, otraj, conf, rel_idex)
                        last_active.remove(r)
                        cur_active.append(r)
                        merged = True
                        break
            if not merged:
                r = VideoRelation(s_cid, pid, o_cid, straj, otraj, fstart,
                                  confs=conf, idex=rel_idex, objects=objects,
                                  predicates=predicates)
                video_relation_list.append(r)
                cur_active.append(r)
        last_active = cur_active
    return [r.serialize() for r in video_relation_list
            if len(r.straj) >= min_length]


def association(frame_relations: Dict[str, list],
                invalid_num: int = 4,
                max_num_per_video: int = 200,
                objects: Sequence[str] = (),
                predicates: Sequence[str] = (),
                verbose: bool = False) -> Dict[str, List[Dict]]:
    """Gap-fill + per-video greedy association. [lib/utils.py:461-526]

    Empty frames borrow the nearest non-empty frame's detections when one is
    at most ``invalid_num`` frames away in BOTH directions of a local window;
    frames isolated inside an all-empty window are invalidated.
    """
    video_relations: Dict[str, List[Dict]] = {}
    for vid, pred in frame_relations.items():
        pred = sorted(pred, key=lambda x: int(x[0]))
        n = len(pred)
        mask = [0 if len(pred[i][1]) == 0 else -1 for i in range(n)]
        if -1 not in mask:
            if verbose:
                print(f"{vid} is empty!!!")
            continue
        # nearest non-empty frame for each empty frame
        fill = [-1] * n
        for i in range(n):
            if mask[i] != 0:
                continue
            j = i - 1
            while j >= 0 and mask[j] == 0:
                j -= 1
            left = 0 if j < 0 else i - j
            j = i + 1
            while j < n and mask[j] == 0:
                j += 1
            right = 0 if j >= n else j - i
            if right == 0 or (0 < left <= right):
                fill[i] = i - left
            elif left == 0 or left > right:
                fill[i] = i + right
        mask = fill
        # invalidate empties whose +-invalid_num window is entirely empty
        for i in range(n):
            if mask[i] >= 0:
                start = max(0, i - invalid_num)
                end = min(n - 1, i + invalid_num)
                if i < invalid_num:
                    end = min(i + invalid_num, n - 1)
                if all(mask[j] != -1 for j in range(start, end + 1)):
                    mask[i] = -2
        for i in range(n):
            if mask[i] > -1:
                pred[i][1] = pred[mask[i]][1]

        rels = greedy_relational_association(pred, objects=objects,
                                             predicates=predicates)
        rels.sort(key=lambda x: x["score"], reverse=True)
        video_relations[vid] = rels[:max_num_per_video]
    return video_relations
