"""The serving comparison: the labels the timed scan voted, against the
plain reference's routed scores of the same views.

For every distinct view the reference (fp32, TF32 off, its own voxelization
and kernel maps, its own text banks from the same tokens) gives every point
its routed ensemble scores and its label. Each time the scan served that
view, its votes gave every valid point one label. Per labelling, against
the fp32 reference:

- the share of labels that are not the reference's (`disagree`);
- the share the reference's own routing rules out (a base/novel routing
  flip of the binary head, `routed_out`).

At random weights the class scores lie close together and the binary
logits close to the routing threshold, so how many labels bf16 rounding
alone flips swings from seed to seed (1.3% to 10% of points, PERF.md). The
witness, the reference itself computed in bf16, reads that share on the
same weights and views; the number compared is the program's excess over
the witness (`disagree_excess`), which a sound bf16 program keeps near zero
and a lower precision or a fault does not. The routing flips' excess is
logged beside it and not compared: on some weights no binary logit lies
near the threshold, and then no precision flips one (PERF.md).
`unvoted_rows` counts rows whose vote count is not one for a valid point
and zero for padding, over every scene (exact, limit 0).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.reference.data.collate import collate_views
from benchmark.reference.engine.infer import ensemble_and_route

ROUTED_OUT = -1e9  # the routing's ruled-out columns hold -1e10


@torch.no_grad()
def reference_scores(model, conf: Dict, views: List[Dict], caps: Dict, statics: Dict,
                     device, voxel_size: float) -> List[Dict]:
    """Per view: routed scores (P, C) and labels (P,) on the host, the
    point mask (P,)."""
    mc = model.cfg
    out = []
    for v in views:
        batch = collate_views([v], caps["max_points"], caps["max_voxels"], caps["max_targets"],
                              voxel_size, device)
        o = model.eval_forward(batch, statics)
        r = ensemble_and_route(o, mc.base_category, mc.novel_category, mc.num_test_classes,
                               conf["base_ratio"], conf["novel_ratio"])
        out.append({"routed": r["routed"][0].float().cpu(), "pred": r["pred"][0].cpu(),
                    "valid": batch["point_valid"][0].cpu()})
    return out


def compare(ref: List[Dict], served: Dict[int, List[np.ndarray]]) -> Dict[str, float]:
    """`served[i]`: every label row (P,) given for view i. Shares over all
    (point, labelling) pairs of valid points."""
    n = wrong = routed_out = 0
    for i, r in enumerate(ref):
        valid = r["valid"].numpy()
        routed = r["routed"].numpy()[valid]
        pred = r["pred"].numpy()[valid]
        for labels in served.get(i, []):
            lab = labels[valid].astype(np.int64)
            n += len(lab)
            wrong += int((lab != pred).sum())
            routed_out += int((np.take_along_axis(routed, lab[:, None], 1) < ROUTED_OUT).sum())
    if n == 0:
        return {"disagree": 1.0, "routed_out": 1.0, "compared": 0}
    return {"disagree": wrong / n, "routed_out": routed_out / n, "compared": n}


def excess(program: Dict, witness: Dict) -> Dict[str, float]:
    return {"disagree_excess": program["disagree"] - witness["disagree"],
            "routed_out_excess": program["routed_out"] - witness["routed_out"]}


COMPARED = ("disagree_excess",)
