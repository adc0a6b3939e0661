"""``expert_load.<cell>``: how unevenly the router loads the experts in
the decode steps of the profiled slice: the most pairs one expert took in
a step over the mean pairs an expert, averaged over the steps and the MoE
layers, from the program's device counters (``MakeAScene.routed_pairs``,
read before and after the slice).  1 is an even load; the busiest expert's
rows set the time of a grouped product bound by its largest tile."""

from __future__ import annotations


def read(name: str, obs: dict):
    return obs.get("expert_load")
