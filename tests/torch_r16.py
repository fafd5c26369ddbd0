"""The radix-16 route's schedule as plain torch (csrc/fftconv.cu::
fftconv_r16_kernel and fftconv_dkf_r16_kernel), shared by the CPU tests of
kernels 1, 1f, 5 and 5f: the radices' DFTs, the Stockham passes with their
index maps, the twiddles as the kernels form them (running products, or
products of once-rounded roots), the merged pass's pairs and fold, and the
whole conv schedule (:func:`_model`).  Imports no JAX."""

import math

import torch

C64 = torch.complex64


def _dft(v, inverse):
    """Unnormalised DFT along the last axis (forward exp(-2 pi i / R))."""
    R = v.shape[-1]
    r = torch.arange(R, dtype=torch.float64)
    sign = 1.0 if inverse else -1.0
    W = torch.polar(torch.ones(R, R, dtype=torch.float64),
                    sign * 2 * math.pi * torch.outer(r, r) / R).to(C64)
    return v @ W.T


def _root(m, N, inverse=False):
    """exp(-+2 pi i m / N) in complex64, as sincospif gives it."""
    m = torch.as_tensor(m, dtype=torch.float64)
    return torch.polar(torch.ones_like(m), (1.0 if inverse else -1.0) * 2
                       * math.pi * m / N).to(C64)


def _chain(k, R, N, inverse):
    """The kernel's twiddles W_N^(k r), r < R, as a running product of
    w1 = W_N^k (csrc/fftconv.cu::twiddle_chain)."""
    w1 = _root(k, N, inverse)
    ws = [torch.ones_like(w1), w1]
    for _ in range(2, R):
        ws.append(ws[-1] * w1)
    return torch.stack(ws, dim=-1)


def _roots_chain(a):
    """The twiddles W^(k r), r < 16, from the roots a (..., 4) = W^(2^i k)
    as csrc/fftconv.cu::pow16 and twiddle16 form them: each the product
    of at most two of W^(s k), W^(4 s k), s < 4."""
    one = torch.ones_like(a[..., 0])
    p = [one, a[..., 0], a[..., 1], a[..., 1] * a[..., 0]]
    q = [one, a[..., 2], a[..., 3], a[..., 3] * a[..., 2]]
    return torch.stack([q[r >> 2] if r & 3 == 0 else p[r & 3] if r < 4
                        else q[r >> 2] * p[r & 3] for r in range(16)], -1)


def _roots_pass_chain(k, R, N, inverse):
    """A pass's twiddles from the roots W^(2^i k) at N (csrc r16_pass,
    ROOTS)."""
    assert R == 16
    k = torch.as_tensor(k)
    return _roots_chain(torch.stack([_root(k << i, N, inverse)
                                     for i in range(4)], -1))


def _pass(z, R, Ns, inverse, NT, chain=None):
    """One Stockham pass as the kernel's threads run it: butterfly j = tid
    + q NT reads z[j + r M/R], twiddles by W_(Ns R)^(k r), k = j mod Ns
    (as ``chain`` computes them, by default :func:`_chain`), transforms,
    and writes z[(j - k) R + k + r Ns]."""
    M = z.shape[-1]
    j = torch.arange(M // R)
    r = torch.arange(R)
    k = j % Ns
    v = z[:, j[:, None] + r[None, :] * (M // R)]
    if Ns > 1:
        v = v * (chain or _chain)(k, R, Ns * R, inverse)
    v = _dft(v, inverse)
    out = torch.full_like(z, float("nan"))
    out[:, (j - k)[:, None] * R + k[:, None] + r[None, :] * Ns] = v
    assert not torch.isnan(out.real).any()          # every slot written
    return out


def _fold(zk, zm, w, kk, km):
    """Z'[k] from Z[k], Z[M-k], W^k = exp(-i pi k / M) and the spectrum at
    k and M - k: the split into the real row's bins, the product, and the
    inverse's packing (csrc/fftconv.cu::fold_pair)."""
    e = 0.5 * (zk + zm.conj())
    o = (zk - zm.conj()) / 2j
    xk, xm = e + w * o, (e - w * o).conj()
    yk, ym = xk * kk, xm * km
    sa, sb = yk + ym.conj(), yk - ym.conj()
    return sa + 1j * (w.conj() * sb)


def _held(M):
    """For each thread t < M/32 of the merged pass, its 32 held values'
    bins k (values s < 16: butterfly j0 = t, output s; s >= 16: butterfly
    j1, output s - 16) and the slot s' that holds bin M - k."""
    T, S = M // 32, M // 16
    t = torch.arange(T)
    j1 = torch.where(t == 0, torch.tensor(T), S - t)
    s = torch.arange(32)
    k = torch.where(s[None] < 16, t[:, None] + s[None] * S,
                    j1[:, None] + (s[None] - 16) * S)
    # t >= 1: output r of j0 with output 15 - r of j1; t = 0: outputs r
    # and 16 - r of j0 = 0 (0 is the DC bin, 8 bin M/2), r and 15 - r of
    # j1 = M/32
    partner = (31 - s).expand(T, 32).clone()
    partner[0, :16] = torch.tensor([0] + [16 - r for r in range(1, 16)])
    partner[0, 16:] = 47 - s[16:]
    return k, partner, j1


def _model(x, kp, L, plan, roots=False):
    """The kernel's schedule on conv inputs x (R, L) f32 and the spectrum
    kp (R, M+1) complex64 (kernel 1f's: the D-skip added, or conjugated):
    y (R, L) f32, before the epilogue's D-skip (kernel 1's), GELU and
    rounding.  ``roots``: kernel 1's f32 instances' twiddles, products of
    once-rounded roots (csrc/fftconv.cu::twiddle16) in the forward
    radix-16 passes, the last forward one (r16_last_forward_roots), a
    radix-16 store pass and the inverse radix-16 passes but where R0 = 16
    (INV_ROOTS: there running products); else kernel 1f's running
    products."""
    R0 = plan.radices[0]
    M = R0 * 16 ** (len(plan.radices) - 1)
    NT, n = plan.threads, 2 * M
    # the load pass: packed p = j + r M/R0 read only where 2p < L (the
    # values past L are zero, so where L <= M the upper half is never
    # read), radix R0 at Ns = 1
    Lp = (L + 1) // 2
    xp = torch.zeros(x.shape[0], 2 * Lp)
    xp[:, :L] = x
    packed = torch.complex(xp[:, 0::2], xp[:, 1::2])
    j, r = torch.arange(M // R0), torch.arange(R0)
    p = j[:, None] + r[None, :] * (M // R0)
    v = torch.zeros(x.shape[0], M // R0, R0, dtype=C64)
    live = p < Lp
    v[:, live] = packed[:, p[live]]
    if L <= M:
        assert not live[:, R0 // 2:].any()
    z = torch.empty(x.shape[0], M, dtype=C64)
    z[:, j[:, None] * R0 + r[None, :]] = _dft(v, False)
    # the forward radix-16 passes, all but the last
    chain = _roots_pass_chain if roots else None
    Ns = R0
    for _ in plan.radices[1:-1]:
        z = _pass(z, 16, Ns, False, NT, chain)
        Ns *= 16
    assert Ns * 16 == M
    # the merged pass: the last forward pass on each thread's two
    # butterflies, the fold of their pairs, the first inverse pass
    k, partner, j1 = _held(M)
    T, S = M // 32, M // 16
    js = torch.cat([torch.arange(T)[:, None].expand(T, 16),
                    j1[:, None].expand(T, 16)], dim=1)
    rs = torch.arange(32) % 16
    vals = torch.stack([z[:, js[:, :16] + rs[None, :16] * S],
                        z[:, js[:, 16:] + rs[None, 16:] * S]], dim=2)
    if roots:
        # j0 = t's roots a[i] = W_M^(2^i t), j1 = M/16 - t's W_16^(2^i)
        # conj(a[i]) (thread 0's j1 = M/32: W_32^(2^i))
        t = torch.arange(T)
        a = torch.stack([_root(t << i, M) for i in range(4)], -1)
        a1 = torch.stack([_root(S << i, M) * a[:, i].conj()
                          for i in range(4)], -1)
        a1[0] = torch.stack([_root(T << i, M) for i in range(4)])
        tw = [_roots_chain(a), _roots_chain(a1)]
    else:
        tw = [_chain(torch.arange(T), 16, M, False), _chain(j1, 16, M, False)]
    vals = vals * torch.stack(tw, dim=1)
    vals = _dft(vals, False).reshape(x.shape[0], T, 32)   # Z[k] at slots
    assert torch.equal(torch.sort(k.flatten()).values, torch.arange(M))
    assert torch.equal(torch.gather(k, 1, partner), (M - k) % M)
    zm = torch.gather(vals, 2, partner[None].expand_as(vals))
    half = _root(k, 2 * M)                            # exp(-i pi k / M)
    kk, km = kp[:, k], kp[:, (M - k) % M]
    new = _fold(vals, zm, half, kk, km)
    z0 = vals[:, 0, 0]                                # DC and Nyquist
    y0 = (z0.real + z0.imag) * kp[:, 0].real
    yM = (z0.real - z0.imag) * kp[:, M].real
    new[:, 0, 0] = torch.complex(y0 + yM, y0 - yM)
    out = _dft(new.reshape(x.shape[0], T, 2, 16), True)
    z = torch.empty_like(z)
    z[:, js[:, :16] * 16 + rs[None, :16]] = out[:, :, 0]
    z[:, js[:, 16:] * 16 + rs[None, 16:]] = out[:, :, 1]
    # the inverse radix-16 passes, then the store pass: radix R0 at
    # Ns = M / R0, packed output p = j + r M/R0 stored only where 2p < L
    Ns = 16
    for _ in plan.radices[2:]:
        z = _pass(z, 16, Ns, True, NT, chain if R0 < 16 else None)
        Ns *= 16
    assert Ns * R0 == M
    v = z[:, p] * (_roots_pass_chain if roots and R0 == 16 else _chain)(
        j, R0, M, True)
    v = _dft(v, True) / n
    y = torch.zeros(x.shape[0], 2 * M)
    y[:, 0::2][:, p] = v.real
    y[:, 1::2][:, p] = v.imag
    return y[:, :L]


