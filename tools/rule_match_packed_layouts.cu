// Every layout of the packed rule-match kernel, for
// tools/rule_match_packed_designs.py to time beside the one that
// src/repro_torch/csrc/rule_match_packed.cu ships (the rules on M, one
// warpgroup): the queries on M, and two warpgroups of rules a CTA.  Built
// with -I src/repro_torch/csrc.

#include "rule_match_wgmma.cuh"

// rule_match_packed_launch's arguments, with the layout before the
// geometry: rules_on_m and wg as rule_match_int8_launch takes them.
extern "C" int rule_match_packed_layouts_launch(
    const void* Qw, const void* Aw, const void* sizes, const void* conf,
    void* out, int B, int R, int W, int rules_on_m, int wg, int n, int cs,
    void* stream) {
  const RuleMatchArgs a{Qw, Aw, sizes, static_cast<const float*>(conf),
                        static_cast<float*>(out), B, R, 4 * W, cs,
                        static_cast<cudaStream_t>(stream)};
  return rule_match_launch<true>(a, rules_on_m, wg, n);
}
