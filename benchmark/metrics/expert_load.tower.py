"""expert_load.tower (%): the busiest expert's routed rows over the mean
expert's, summed over the MoE layers, from the tower's routed counts
(`TowerStats`) of the window outside its traced stretch: 100 when every
expert of every layer takes the same share.  A grouped product waits
for its busiest expert's tiles, so this is how far the routing
stretches the expert kernels.  Layer: the experts."""


def read(rec):
    routed = rec.work.get("routed")
    if not routed:
        return None
    busiest = sum(max(layer) for layer in routed)
    mean = sum(sum(layer) / len(layer) for layer in routed)
    if mean <= 0:
        return None
    return 100.0 * busiest / mean
