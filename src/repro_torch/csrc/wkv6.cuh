// What the WKV-6 forward (wkv6.cu) and backward (wkv6_bwd.cu) kernels
// share.
#pragma once

// Steps between two checkpoints of the state.  Under training the forward
// stores the state entering every kWkvChunk-th step; the backward
// recomputes one chunk's states from its checkpoint into registers (each
// lane the chunk's kWkvChunk states of its columns of one row) before it
// walks that chunk back.  The wrapper's CHUNK (kernels/rwkv6_wkv/kernel.py)
// is this number.
constexpr int kWkvChunk = 8;
