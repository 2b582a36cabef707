// Every tile of the packed support-count kernel, for
// tools/support_count_packed_designs.py to time beside the one that
// src/repro_torch/csrc/support_count_packed.cu ships (64 transactions by
// 64 candidates): one or two consumer warpgroups against 64, 128 or 256
// candidates, each walking `tiles` transaction tiles.  Built with -I
// src/repro_torch/csrc.

#include "support_count_wgmma.cuh"

// support_count_packed_launch's arguments, with the tile before the walk
// and the ring after it: wg in {1, 2}, n in {64, 128, 256}, up to
// `stages` slabs in flight.
extern "C" int support_count_packed_tiles_launch(
    const void* Tw, const void* Cw, const void* sizes, void* out, int N,
    int M, int W, int wg, int n, int tiles, int stages, void* stream) {
  const SupportCountArgs a{Tw, Cw, static_cast<const int*>(sizes),
                           static_cast<int*>(out), N, M, 4 * W, tiles,
                           stages, static_cast<cudaStream_t>(stream)};
  return support_count_launch<true>(a, wg, n);
}
