"""The solver loops of the implicit steps as predicated launches (the
counterpart of the JAX package's on-device ``lax.while_loop``).

The JAX steps run each solver loop (IISPH's Jacobi solve, PCISPH's
corrective loop, DFSPH's divergence and density solves, the implicit
viscosity CG) as one ``lax.while_loop`` with the condition
``((err > tol) | (it < min_iters)) & (it < max_iters)``. Here the host
launches the body again and again: each launched iteration computes its
candidate carry from the committed one, and
:meth:`PredicatedLoop.commit` keeps a candidate only where the condition
of the carry the iteration started from holds. An iteration launched
after the loop has ended therefore changes nothing, and the iteration
count and the carry are the while loop's. The host reads the
condition after every ``sync_every``-th launched iteration from
``min_iters`` on (before it, the condition holds), the only
synchronisation of the loop, and stops launching when it is false: up to
``sync_every − 1`` launched iterations past the loop's end are frozen.
"""

from __future__ import annotations

import torch


class LoopCounts:
    """Iterations launched and host reads of the loop condition, summed
    over steps until :meth:`reset`, and the last finished run of the loop
    (``last``: its final ``it``, ``err``, ``tol`` and ``max_iters``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.launched = 0
        self.syncs = 0
        self.last = None


class PredicatedLoop:
    """One run of a solver loop. Iterate over it to launch iterations; in
    each, :meth:`commit` every carried value, then :meth:`advance` with
    the iteration's error (the loop's ``err`` carry)::

        loop = PredicatedLoop(LOOP, like=dens, tol=tol, min_iters=2,
                              max_iters=100, sync_every=2, err0=2 * tol)
        for _ in loop:
            p_new, err = body(p)
            p = loop.commit(p_new, p)
            loop.advance(err)
        iters, err = loop.it, loop.err
    """

    def __init__(self, counts: LoopCounts, *, like: torch.Tensor, tol,
                 min_iters: int, max_iters: int, sync_every: int, err0):
        """``tol`` and ``err0`` are Python floats or 0-d tensors on
        ``like``'s device (CG's first error is its initial residual)."""
        self.counts = counts
        self.tol = tol
        self.min_iters = min_iters
        self.max_iters = max_iters
        self.sync_every = sync_every
        self.err = (err0 if torch.is_tensor(err0) else
                    torch.full((), err0, dtype=like.dtype, device=like.device))
        self.it = torch.zeros((), dtype=torch.int32, device=like.device)
        self.go = self._cond()

    def _cond(self):
        return (((self.err > self.tol) | (self.it < self.min_iters))
                & (self.it < self.max_iters))

    def __iter__(self):
        for n in range(1, self.max_iters + 1):
            yield n
            self.counts.launched += 1
            if n >= self.min_iters and n % self.sync_every == 0:
                self.counts.syncs += 1
                if not bool(self.go):
                    break
        self.counts.last = self

    def commit(self, new, old):
        """``new`` where this iteration runs, else ``old``."""
        return torch.where(self.go, new, old)

    def advance(self, err):
        """Commits the iteration's error and count, then evaluates the
        condition for the next iteration; call after every
        :meth:`commit` of the iteration."""
        self.err = torch.where(self.go, err, self.err)
        self.it = self.it + self.go.to(torch.int32)
        self.go = self._cond()
