"""mip-NeRF 360's ReLU backward with its bias gradient (ops/relu_bgrad.py,
csrc/relu_bgrad.cu): the wrapper's plain version and checks, and
`_DenseReLU`'s gradients through it, on the CPU.

  * the plain version's g is threshold_backward's bit for bit (y with
    positives, +0.0, -0.0, negatives and NaN; grad contiguous or a
    1024-column view of a 1096-wide gradient, as layer 4's arrives), and
    its db the float32 column sum of that g;
  * `_DenseReLU`'s data and weight gradients are the old expressions' bit
    for bit; its bias gradient is within one bf16 rounding of the old
    one (which rounded the sum to bf16) and within float32 rounding of a
    float64 sum, closer to it than the old one;
  * the wrapper raises on float32 and on shapes that differ; it reads a
    gradient whose strides are not rows of adjacent columns from a
    contiguous copy, and copies nothing else; a width, row stride or
    address that is not whole 16-byte words leaves the 16-byte path.
The kernel itself is held against threshold_backward on the card
(tests/test_torch_cuda.py).
"""
import pytest
import torch

from nerf_pl_tpu_torch.models.mipnerf360 import _DenseReLU
from nerf_pl_tpu_torch.ops import relu_bgrad as R

BF = torch.bfloat16


def _threshold(grad, y):
    return torch.ops.aten.threshold_backward(grad, y, 0)


def _y(P, N, seed, specials=True):
    """bf16 activations: ReLU outputs (about half +0.0, the rest positive)
    and, with `specials`, -0.0, negatives and NaN planted in rows."""
    gen = torch.Generator().manual_seed(seed)
    y = torch.relu(torch.randn((P, N), generator=gen)).to(BF)
    if specials:
        y[0::7, 1::3] = -0.0
        y[1::5, 0::4] = -torch.rand((len(range(1, P, 5)),
                                     len(range(0, N, 4))), generator=gen).to(BF)
        y[2::11, 2::5] = float("nan")
    return y


def _grad(P, N, seed, width=None):
    """A bf16 gradient [P, N]; with `width`, the first N columns of a
    [P, width] one, a view whose rows lie `width` apart."""
    gen = torch.Generator().manual_seed(seed + 1)
    full = torch.randn((P, width or N), generator=gen).to(BF)
    return full[:, :N] if width else full


CASES = [(64, 1024, None), (64, 1024, 1096), (300, 256, None),
         (257, 128, None), (97, 100, None), (33, 100, 104), (5, 3, None)]


@pytest.mark.parametrize("P,N,width", CASES)
def test_plain_g_is_threshold_backwards_bit_for_bit(P, N, width):
    y, grad = _y(P, N, 0), _grad(P, N, 0, width)
    for g, db in (R.relu_bgrad_plain(grad, y), R.relu_bgrad(grad, y)):
        want = _threshold(grad, y)
        assert g.dtype == BF and g.shape == (P, N)
        assert torch.equal(g.view(torch.int16), want.view(torch.int16))
        assert db.dtype == torch.float32 and db.shape == (N,)
        assert torch.equal(db, want.float().sum(0))


@pytest.mark.parametrize("P,N,width", CASES)
def test_wrapper_on_the_cpu_launches_nothing(P, N, width):
    n0 = R.relu_bgrad_launches
    R.relu_bgrad(_grad(P, N, 1, width), _y(P, N, 1))
    assert R.relu_bgrad_launches == n0


def _layer(P, K, N, seed):
    """A bf16 layer's input x, float32 master w and b, as the model holds
    them."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.relu(torch.randn((P, K), generator=gen)).to(BF)
    w = torch.randn((K, N), generator=gen) * (2.0 / K) ** 0.5
    b = torch.randn((N,), generator=gen) * 0.1
    return x, w, b


def _old_backward(x, w, b, grad):
    """_DenseReLU's backward before this kernel: threshold_backward, the
    two products and the bias's bf16 column sum widened."""
    wb = w.to(BF)
    y = torch._addmm_activation(b.to(BF), x, wb)
    g = _threshold(grad.contiguous(), y)
    return g @ wb.t(), (x.t() @ g).float(), g.sum(0).float(), g


@pytest.mark.parametrize("P,K,N,width", [(512, 72, 256, None),
                                         (256, 1024, 1024, 1096),
                                         (384, 283, 128, None),
                                         (200, 64, 100, None)])
def test_dense_relu_gradients_against_the_old_expressions(P, K, N, width):
    """Through autograd as the model runs it: where `width` is given, the
    layer's output is concatenated to width - N more columns, so its
    gradient arrives as a narrow view."""
    x, w, b = _layer(P, K, N, 3)
    xs, ws, bs = (t.clone().requires_grad_() for t in (x, w, b))
    y = _DenseReLU.apply(xs, ws, bs)
    out = torch.cat([y, torch.zeros((P, width - N), dtype=BF)], -1) \
        if width else y
    gen = torch.Generator().manual_seed(4)
    G = torch.randn(out.shape, generator=gen).to(BF)
    out.backward(G)
    gx, gw, gb_old, g = _old_backward(x, w, b, G[:, :N])
    assert torch.equal(xs.grad.view(torch.int16), gx.view(torch.int16))
    assert torch.equal(ws.grad, gw)
    gb = bs.grad
    assert gb.dtype == torch.float32
    ref = g.double().sum(0)
    scale = g.double().abs().sum(0) + 1e-30
    # the old sum differs by its one rounding to bf16
    assert ((gb.double() - gb_old.double()).abs()
            <= gb.double().abs() * 2.0 ** -8 + 1e-6 * scale).all()
    err_new = ((gb.double() - ref).abs() / scale).max().item()
    err_old = ((gb_old.double() - ref).abs() / scale).max().item()
    assert err_new <= 1e-6
    assert err_new <= err_old


def test_dense_relu_step_makes_no_threshold_backward(monkeypatch):
    """The layer's backward goes through relu_bgrad once and never calls
    threshold_backward."""
    calls = []
    real = R.relu_bgrad

    def counted(grad, y):
        calls.append(tuple(y.shape))
        return real(grad, y)

    import nerf_pl_tpu_torch.models.mipnerf360 as mm
    monkeypatch.setattr(mm, "relu_bgrad", counted)
    x, w, b = _layer(64, 72, 256, 5)
    w.requires_grad_()
    b.requires_grad_()
    with torch.autograd.profiler.profile() as prof:
        _DenseReLU.apply(x, w, b).float().sum().backward()
    assert calls == [(64, 256)]
    assert not any("threshold_backward" in e.name
                   for e in prof.function_events)


@pytest.mark.parametrize("what", ["float32 grad", "float32 y", "shape",
                                  "1-d", "y strided"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(what):
    y, grad = _y(16, 64, 2), _grad(16, 64, 2)
    args = {"float32 grad": (grad.float(), y),
            "float32 y": (grad, y.float()),
            "shape": (grad[:, :32], y),
            "1-d": (grad[0], y[0]),
            "y strided": (grad, _y(16, 128, 2)[:, :64])}[what]
    with pytest.raises(ValueError):
        R.relu_bgrad(*args)


@pytest.mark.parametrize("what", ["columns apart", "rows overlap"])
def test_wrapper_reads_a_grad_that_is_not_rows_from_a_copy(what):
    """A gradient whose columns are not adjacent, or whose rows overlap,
    is read from a contiguous copy: g is threshold_backward's bit for
    bit."""
    y = _y(16, 64, 2)
    grad = {"columns apart": _grad(16, 128, 2)[:, ::2],
            "rows overlap": _grad(16, 64, 2).as_strided((16, 64),
                                                        (32, 1))}[what]
    g, db = R.relu_bgrad(grad, y)
    want = _threshold(grad.contiguous(), y)
    assert torch.equal(g.view(torch.int16), want.view(torch.int16))
    assert torch.equal(db, want.float().sum(0))


def _misaligned(P, N, seed):
    """The columns 1 .. N of a [P, N + 72] gradient: rows 8-aligned apart
    but every row's first value one bf16 past a 16-byte word."""
    return _grad(P, N + 72, seed)[:, 1:N + 1]


@pytest.mark.parametrize("P,N,width", [(16, 100, None), (16, 1024, 1100),
                                       (16, 1024, 1092), (16, 1024, "off")])
def test_vector_path_refuses_what_is_not_whole_words(P, N, width):
    """A width, row stride or address that is not whole 16-byte words
    does not fit the 16-byte path; the wrapper takes the element-wise one
    by itself, with threshold_backward's bits."""
    y = _y(P, N, 3)
    grad = _misaligned(P, N, 3) if width == "off" else _grad(P, N, 3, width)
    assert not R.fits_vector(grad, y)
    g, _ = R.relu_bgrad(grad, y)
    assert torch.equal(g.view(torch.int16),
                       _threshold(grad, y).view(torch.int16))


@pytest.mark.parametrize("P,N,width", [(16, 1024, 1096), (16, 256, None),
                                       (16, 128, None)])
def test_cell_shapes_fit_the_vector_path(P, N, width):
    y, grad = _y(P, N, 4), _grad(P, N, 4, width)
    assert R.fits_vector(grad, y)
    g, _ = R.relu_bgrad(grad, y)
    assert torch.equal(g.view(torch.int16),
                       _threshold(grad, y).view(torch.int16))


def test_as_rows_copies_only_what_the_kernel_cannot_read():
    full = _grad(8, 1096, 5)
    narrow = full[:, :1024]
    assert R._rows(narrow) is narrow
    assert R._rows(full) is full
    for t in (full.t(), full[:, ::2], full[:, :8].expand(8, 8).t(),
              torch.zeros((1, 8), dtype=BF).expand(4, 8)):
        out = R._rows(t)
        assert out.is_contiguous() and torch.equal(out, t)
