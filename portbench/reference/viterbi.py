"""The CTC Viterbi of the reference: the best path over the states of a
blank-interleaved token sequence.

Transitions from frame t − 1 to t: stay, s − 1, and s − 2 where
tokens[s] != tokens[s − 2]; the path starts in state 0 or 1 and ends in
S − 1, or in S − 2 where that scores strictly higher; scores are f32 sums
of the states' log-probs. Of equal candidates the first wins: stay, then
s − 1, then s − 2. The recurrence runs over the frames in plain PyTorch;
on a CUDA device `GRAPH_FRAMES` frames at a time as a CUDA graph, which
replays the same operations.
"""

from __future__ import annotations

import numpy as np
import torch

GRAPH_FRAMES = 128


def _step(prev, emit, skip, neg):
    """The scores after one frame, and the step (0, 1 or 2) that won each."""
    one = torch.cat([neg[:1], prev[:-1]])
    two = torch.where(skip, torch.cat([neg[:2], prev[:-2]]), neg)
    best, step = torch.max(torch.stack([prev, one, two]), dim=0)  # the first of equals
    return best + emit, step.to(torch.uint8)


def best_path(log_probs: torch.Tensor, tokens) -> np.ndarray:
    """The best path (the state of each frame) under log_probs [T, V] f32."""
    dev = log_probs.device
    tok = torch.as_tensor(np.asarray(tokens, np.int64), device=dev)
    s, t_len = len(tokens), int(log_probs.shape[0])
    skip = torch.zeros(s, dtype=torch.bool, device=dev)
    if s > 2:
        skip[2:] = tok[2:] != tok[:-2]
    neg = torch.full((s,), float("-inf"), device=dev)
    prev = neg.clone()
    prev[: min(2, s)] = log_probs[0, tok[: min(2, s)]]
    steps = torch.zeros(t_len, s, dtype=torch.uint8, device=dev)
    t = 1
    if dev.type == "cuda" and t_len > GRAPH_FRAMES:
        prev, t = _graph_frames(log_probs, tok, prev, steps, skip, neg)
    for t in range(t, t_len):
        prev, steps[t] = _step(prev, log_probs[t, tok], skip, neg)
    final = prev.cpu().numpy()
    state = s - 1 if s < 2 or not final[s - 2] > final[s - 1] else s - 2
    steps_h = steps.cpu().numpy()
    path = np.zeros(t_len, np.int64)
    for t in range(t_len - 1, -1, -1):
        path[t] = state
        state -= int(steps_h[t, state])
    return path


def _graph_frames(log_probs, tok, prev, steps, skip, neg):
    """Frames 1 … in blocks of GRAPH_FRAMES replayed from one CUDA graph;
    returns the scores after the last whole block and the next frame."""
    static_prev = prev.clone()
    static_emit = torch.zeros(GRAPH_FRAMES, len(tok), device=prev.device)
    static_steps = torch.zeros(GRAPH_FRAMES, len(tok), dtype=torch.uint8, device=prev.device)

    def block():
        cur = static_prev
        for f in range(GRAPH_FRAMES):
            cur, static_steps[f] = _step(cur, static_emit[f], skip, neg)
        return cur

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        block()  # the allocator's blocks, outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = block()
    t = 1
    while t + GRAPH_FRAMES <= log_probs.shape[0]:
        static_prev.copy_(prev)
        static_emit.copy_(log_probs[t: t + GRAPH_FRAMES][:, tok])
        graph.replay()
        steps[t: t + GRAPH_FRAMES] = static_steps
        prev = static_out.clone()
        t += GRAPH_FRAMES
    return prev, t
