"""Downstream evaluation harnesses (posfeat_tpu/evals): HPatches MMA,
Aachen Day-Night localization, ETH SfM local-feature benchmark. Matching
runs on the device through ``ops.matchers``; the rest is host-side numpy,
sqlite and the COLMAP binary."""
