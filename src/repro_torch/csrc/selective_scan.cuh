// What the selective scan's forward (selective_scan.cu) and backward
// (selective_scan_bwd.cu) kernels share.
#pragma once

// Steps a thread walks between two checkpoints.  The forward loads this
// many steps of a, b and C ahead into registers, and under training it
// stores h at each chunk's start; the backward recomputes one chunk's h in
// registers from its checkpoint before it walks that chunk back.  The
// wrapper's CHUNK (kernels/selective_scan/kernel.py) is this number.
constexpr int kScanChunk = 16;
