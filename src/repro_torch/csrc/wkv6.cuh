// What the WKV-6 forward (wkv6.cu) and backward (wkv6_bwd.cu) kernels
// share.
#pragma once

// Steps between two checkpoints of the state.  Under training the forward
// stores the state entering every kWkvChunk-th step; the backward
// recomputes one chunk's states from its checkpoint into shared memory
// (kWkvChunk * n * n floats: 128 KB at n = 64) before it walks that chunk
// back.  The wrapper's CHUNK (kernels/rwkv6_wkv/kernel.py) is this number.
constexpr int kWkvChunk = 8;
