"""The S' second-kind BIE of the upstream's helm2_bie example, as the
program's `helm2_bie` twin builds it: the ellipse sampled by
`Ellipse.sample_linspaced`, a `Quadtree`, `make_multilevel` on the host
in float64, `card_system` (the partition plan on K2 and the tree-permuted
KR corrector on the card) and the system 0.5 v + plan(v w) + corr(v w) on
a complex64 vector (`CardBie.sys_apply_complex`)."""

from __future__ import annotations

import numpy as np

from portbench.systems import Clock, System, gmres_solver


def build(config: dict, device, needs) -> System:
    from butterfly_tpu_torch.examples.helm2_bie import card_system
    from butterfly_tpu_torch.fac import helm2 as fac_helm2
    from butterfly_tpu_torch.fac.partition import partition_apply_plan
    from butterfly_tpu_torch.geom import Ellipse
    from butterfly_tpu_torch.ops.helm2 import Helm2, LayerPot
    from butterfly_tpu_torch.trees import Quadtree

    clock = Clock(device)
    e = config["ellipse"]
    n = int(config["n"])
    X, _, N, w = Ellipse(e["semi_major"], e["semi_minor"],
                         tuple(e["center"]), e["theta"]).sample_linspaced(n)
    helm = Helm2(k=float(config["k"]),
                 layer_pot=LayerPot.PV_NORMAL_DERIV_SINGLE)
    tree = Quadtree(X, leaf_size=int(config["leaf_size"]), normals=N)
    perm = np.asarray(tree.perm)
    A = clock("host_fac_s", fac_helm2.make_multilevel, helm, tree, tree)
    if "solve" not in needs:
        plan = clock("plan_s", partition_apply_plan, A, device=device)
        return System(n, perm, A, plan, timings=clock.timings)

    def kernel_ij(i, j):
        return helm.kernel_matrix(X[j:j + 1], X[i:i + 1], None,
                                  N[i:i + 1])[0, 0]

    card = clock("plan_and_corrector_s", card_system, A, perm, w, kernel_ij,
                 int(config["kr_order"]), device=device)
    clock.timings.update(plan_s=card.rec["plan_s"],
                         corrector_s=card.rec["corr_s"])
    solve = gmres_solver(card.sys_apply_complex, perm, card.device,
                         config["gmres"])
    return System(n, perm, A, card.plan, card.corr, solve, clock.timings)
