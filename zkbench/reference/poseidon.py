"""Poseidon (t=3, R_F=8, R_P=56, x^5, cuZK's constants and MDS) in plain
PyTorch, batched over the leading axes (poseidon.cpp:60-126).  The three
state lanes are stacked as ``[..., 3, 16]`` so each round's S-box and MDS
run as one batched field operation.

A permutation is some 40,000 small tensor operations.  On a card, for a
batch of a few thousand states the host's launches would set its time, so
there it is captured once into a CUDA graph of 4,096 states and replayed;
larger batches run eagerly in blocks, where the device sets the time.  The
arithmetic is the eager code's, operation for operation."""

from __future__ import annotations

import torch

from zkbench.reference import constants
from zkbench.reference.field import DTYPE, NDIGITS, Field, carry_keep, int_to_digits

T = constants.T
# Batches of up to GRAPH_STATES states replay the captured permutation;
# larger ones run eagerly, EAGER_BLOCK states at a time.
GRAPH_STATES = 4096
EAGER_BLOCK = 1 << 18
# Product q = 3 i + j multiplies state row j by MDS[3 i + j].
_MDS_SRC_ROW = [j for _ in range(T) for j in range(T)]


def _is_full(r: int) -> bool:
    return (r < constants.HALF_FULL
            or r >= constants.HALF_FULL + constants.PARTIAL_ROUNDS)


class Poseidon:
    """The permutation and the sponge on one device, over a :class:`Field`
    (whose ``k`` the control changes)."""

    def __init__(self, field: Field):
        self.field = field
        dev = field.device
        self.rc = torch.tensor(
            [int_to_digits(x) for x in constants.RC], dtype=DTYPE,
            device=dev).reshape(constants.TOTAL_ROUNDS, T, NDIGITS)
        self.mds = torch.tensor(constants.MDS, dtype=DTYPE, device=dev)
        self.mds_src = torch.tensor(_MDS_SRC_ROW, device=dev)
        self._captured = None

    def _mds_rc(self, s: torch.Tensor, rc_next) -> torch.Tensor:
        """One MDS layer plus the next round's constant on a reduced
        stacked state.  Each product MDS[i][j] * s[j] (a coefficient <= 26
        times a reduced operand) has a high part <= 7, so the fold's mh
        branch never runs and it reduces as add(low, high * k); the row
        sum plus the constant (< 4p) then needs one carry and one reduce:
        the reference's chained adds are exact modular adds there."""
        f = self.field
        prods = s.index_select(-2, self.mds_src) * self.mds[:, None]
        low, high = carry_keep(prods, passes=2)
        hc = carry_keep(high[..., None] * f.k_digits, passes=2)[0]
        m = f.add_canonical(low, hc)
        m = m.reshape(m.shape[:-2] + (T, T, NDIGITS))
        total = m.sum(dim=-2)
        if rc_next is not None:
            total = total + rc_next
        return f.red(carry_keep(total, passes=2)[0])

    def permute(self, state: torch.Tensor) -> torch.Tensor:
        """64 rounds on a reduced ``[..., 3, 16]`` state: add RC[0]; per
        round S-box, MDS, add RC[r + 1] (on reduced operands the
        single-subtract add equals the reference's)."""
        f = self.field
        with torch.inference_mode():
            s = f.add_rr(state, self.rc[0])
            for r in range(constants.TOTAL_ROUNDS):
                if _is_full(r):
                    s = f.power5(s)
                else:
                    s = torch.cat([f.power5(s[..., :1, :]), s[..., 1:, :]],
                                  dim=-2)
                s = self._mds_rc(
                    s, self.rc[r + 1] if r + 1 < constants.TOTAL_ROUNDS else None)
        return s.clone()

    def sponge(self, inputs: torch.Tensor, ds: int) -> torch.Tensor:
        """``[..., n, 16]`` -> ``[..., 16]`` (poseidon.cpp:103-126): ds in
        state[0], pairs absorbed into state[1..2] with the wrapping add,
        one permutation a block, state[1] squeezed; n == 0 gives 0."""
        f = self.field
        n = inputs.shape[-2]
        batch = inputs.shape[:-2]
        state = torch.zeros(batch + (T, NDIGITS), dtype=DTYPE,
                            device=inputs.device)
        if n == 0:
            return state[..., 1, :]
        state[..., 0, 0] = ds
        for i in range(0, n, constants.RATE):
            block = inputs[..., i:i + constants.RATE, :]
            w = block.shape[-2]
            absorbed = f.add(state[..., 1:1 + w, :], block)
            state = torch.cat(
                [state[..., :1, :], absorbed, state[..., 1 + w:, :]], dim=-2)
            state = self.permute_batch(state)
        return state[..., 1, :]

    def _graph(self):
        """(graph, input, output) of the permutation of GRAPH_STATES states,
        captured at the first use after one eager warm-up."""
        if self._captured is None:
            dev = self.field.device
            static_in = torch.zeros((GRAPH_STATES, T, NDIGITS), dtype=DTYPE,
                                    device=dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self.permute(static_in)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                static_out = self.permute(static_in)
            self._captured = (graph, static_in, static_out)
        return self._captured

    def permute_batch(self, state: torch.Tensor) -> torch.Tensor:
        """:meth:`permute` of ``[..., 3, 16]`` states: the captured graph on
        a card for a small batch, else eagerly by blocks."""
        lead = state.shape[:-2]
        flat = state.reshape(-1, T, NDIGITS)
        m = flat.shape[0]
        if state.device.type == "cuda" and m <= GRAPH_STATES:
            graph, static_in, static_out = self._graph()
            static_in[:m].copy_(flat)
            static_in[m:].zero_()
            graph.replay()
            return static_out[:m].clone().reshape(lead + (T, NDIGITS))
        return torch.cat([self.permute(flat[i:i + EAGER_BLOCK])
                          for i in range(0, m, EAGER_BLOCK)]).reshape(
                              lead + (T, NDIGITS))

    def hash_multiple(self, groups: torch.Tensor) -> torch.Tensor:
        """``[g, n, 16]`` -> ``[g, 16]`` (ds = 3)."""
        return self.sponge(groups, constants.DS_MULTIPLE)
