"""The Frechet distance of two feature statistics computed in the
subspace their covariances and mean difference span.

FID is invariant under an orthonormal change of basis, and both
covariances vanish outside that subspace, so the value is the one the
full 2048-d computation gives (up to rounding), while the matrix square
root is of the subspace's size: with n features per set its dimension is
below 2n.  scipy's sqrtm of a 2048^2 product takes ~10-15 s on a CPU, and
far longer when several test processes share one; the tests that hold
FID values of the port against the JAX package on the real network wrap
each package's own frechet_distance with this."""
import numpy as np


def span_frechet(frechet, rtol=1e-12):
    """frechet(a, b, eps) restricted to the span of a.sigma, b.sigma and
    a.mu - b.mu: the left singular vectors of their sum (sketched by a
    random matrix of a.n + b.n + 8 columns, more than its rank, when that
    is narrower) above rtol of the largest singular value."""
    def fd(a, b, eps=1e-6):
        d = (a.mu - b.mu)[:, None]
        m = a.sigma + b.sigma + d @ d.T
        k = a.n + b.n + 8
        if k < m.shape[0]:
            m = m @ np.random.RandomState(0).randn(m.shape[0], k)
        u, sv, _ = np.linalg.svd(m, full_matrices=False)
        u = u[:, sv > rtol * sv.max()]

        def project(s):
            return type(s)(mu=u.T @ s.mu, sigma=u.T @ s.sigma @ u, n=s.n)

        return frechet(project(a), project(b), eps)

    return fd
