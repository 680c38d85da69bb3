"""DualGPM's subspace bookkeeping (``dual_gpm_update`` of
``libcontinual_tpu/methods/inflora.py``), shared by API and the InfLoRA
family.

Each layer keeps an orthonormal basis and a type. A ``remove`` basis spans
the protected input directions (gradients lose their component there); a
``retain`` basis spans the free ones. After a task, each layer's activation
matrix ``(in_dim, n)`` grows a remove basis by the residual's leading
directions until the captured energy reaches ``threshold``, or shrinks a
retain basis by the directions the task's activations now use; a remove
basis past half the space turns into its complement, a retain one. The SVDs
run in ``torch.linalg`` in the matrices' dtype (float64 here, as the JAX
package's numpy) on their device.
"""

from __future__ import annotations

from typing import List

import torch

from libcontinual_tpu_torch.methods.common import energy, svd, svdvals


def dual_gpm_update(feature_list: List[torch.Tensor], project_type: List[str],
                    mat_list: List[torch.Tensor], threshold: float) -> None:
    """Update ``feature_list`` and ``project_type`` in place from one task's
    activation matrices (the first call fills them)."""
    if not feature_list:
        for act in mat_list:
            u, s, _ = svd(act, full_matrices=False)
            ratio = torch.cumsum(s ** 2, 0) / torch.sum(s ** 2)
            r = int(torch.sum(ratio < threshold))
            feature_list.append(u[:, : max(r, 1)])
            project_type.append("remove" if r < act.shape[0] / 2 else "retain")
    else:
        for i, act in enumerate(mat_list):
            sval_total = energy(svdvals(act))
            U = feature_list[i]
            if project_type[i] == "remove":
                act_hat = act - U @ (U.T @ act)
                u, s, _ = svd(act_hat, full_matrices=False)
                accumulated = (sval_total - energy(s)) / sval_total
                r = 0
                for ratio in ((s ** 2) / sval_total).tolist():
                    if accumulated >= threshold:
                        break
                    accumulated += ratio
                    r += 1
                if r == 0:
                    continue
                ui = torch.cat([U, u[:, :r]], dim=1)
                feature_list[i] = ui[:, : min(ui.shape)]
            else:
                act_hat = U @ (U.T @ act)
                u, s, _ = svd(act_hat, full_matrices=False)
                accumulated = energy(s) / sval_total
                r = 0
                for ratio in ((s ** 2) / sval_total).tolist():
                    if accumulated < 1 - threshold:
                        break
                    accumulated -= ratio
                    r += 1
                if r == 0:
                    continue
                act_feature = U - u[:, :r] @ (u[:, :r].T @ U)
                ui, _, _ = svd(act_feature)
                feature_list[i] = ui[:, : U.shape[1] - r]
    # a remove basis past half the space becomes its complement, a retain one
    for i, f in enumerate(feature_list):
        if project_type[i] == "remove" and f.shape[1] > f.shape[0] / 2:
            u, _, _ = svd(f)
            feature_list[i] = u[:, f.shape[1]:]
            project_type[i] = "retain"
