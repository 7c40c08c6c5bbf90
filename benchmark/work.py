"""Work from shapes alone: the model's floating-point operations in a
training step or a sampler call, the capsule layers' least time, and the
card's peaks. Nothing here looks at what an implementation launches: the
same configuration and batch give the same work whatever computes it.

Operations count the products (convolutions, linears, capsule votes and
routing sums) at 2 per multiply-add, forward and each gradient that the
step needs: a weight gradient where the weight trains, an input gradient
where the input carries one. ``tests/test_bench_work.py`` holds the count
to ``torch.utils.flop_counter`` on the plain reference at a small width.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# Published dense peaks of one H100 SXM (NVIDIA's data sheet), at the
# card's 700 W limit.
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12
HBM_BYTES = 3.35e12


# A product: (multiply-adds, has a weight operand, input is the pass's
# own input (the image or the text), routing sum).
Product = Tuple[int, bool, bool, bool]


def _capsule(b: int, i: int, l_: int, j: int, o: int, iters: int,
             first_input: bool = False) -> List[Product]:
    """Votes u = W x, then per pass the weighted sum s = c u and, but for
    the last pass, the agreement u . v."""
    out = [(b * i * l_ * j * o, True, first_input, False)]
    for r in range(iters):
        out.append((b * i * j * o, False, False, r == 0))
        if r < iters - 1:
            out.append((b * i * j * o, False, False, False))
    return out


def generator_products(d: dict, b: int, train: bool, cap: bool
                       ) -> List[Product]:
    """Every product of one generator forward at batch ``b``; in eval
    mode the class code is the prior and VC_NET does not run."""
    out: List[Product] = [(b * d['text'] * d['ef'] * 4, True, True, False)]
    if train:
        out += [(b * (d['z'] + d['entity']) * 512, True, True, False),
                (b * 512 * 256, True, False, False),
                (b * 256 * d['manifd'], True, False, False),
                (b * 256 * d['manifd'], True, False, False)]
    ngf = d['gf'] * 16
    in_dim = d['c_dim'] + d['z']
    if cap:
        out += _capsule(b, -(-in_dim // 8), 8, ngf, 32, d['iters'])
    else:
        out.append((b * in_dim * ngf * 32, True, False, False))
    hw = 4
    for k in range(1, 5):
        hw *= 2
        cin, cout = ngf // 2 ** (k - 1), ngf // 2 ** k
        out.append((b * hw * hw * 2 * cout * cin * 9, True, False, False))
    out.append((b * hw * hw * 3 * d['gf'] * 9, True, False, False))
    ngf = d['gf']
    for _ in range(2, d['branches'] + 1):
        out.append((b * hw * hw * 2 * ngf * (ngf + d['c_dim']) * 9, True,
                    False, False))
        for _r in range(d['r_num']):
            out += [(b * hw * hw * 2 * ngf * ngf * 9, True, False, False),
                    (b * hw * hw * ngf * ngf * 9, True, False, False)]
        hw *= 2
        out.append((b * hw * hw * ngf * ngf * 9, True, False, False))
        ngf //= 2
        out.append((b * hw * hw * 3 * ngf * 9, True, False, False))
    return out


def discriminator_products(d: dict, b: int, size: int, class_head: bool
                           ) -> List[Product]:
    """Every product of one joint-D pass at ``size`` px; ``class_head``
    False leaves the class head out (a pass whose class output no loss
    reads has no gradient there)."""
    ndf = d['df']
    hw = size // 2
    out: List[Product] = [(b * hw * hw * ndf * 3 * 16, True, True, False)]
    for k in (1, 2, 4):
        hw //= 2
        out.append((b * hw * hw * 2 * ndf * k * ndf * k * 16, True, False,
                    False))
    if size == 128:
        out += [(b * 16 * 16 * ndf * 8 * ndf * 16, True, False, False),
                (b * 16 * 8 * ndf * 16 * ndf * 9, True, False, False)]
    out.append((b * 16 * 8 * ndf * (8 * ndf + d['d_cond']) * 9, True, False,
                False))
    out += [(b * 8 * ndf * 16, True, False, False)] * 2
    if class_head:
        if d['d_cap']:
            out += _capsule(b, 16, 8 * ndf, d['entity'] + 1, 16, d['iters'])
        else:
            out.append((b * 8 * ndf * 16 * (d['entity'] + 1), True, False,
                        False))
    return out


def _fwd(products: List[Product]) -> int:
    return sum(2 * m for m, _, _, _ in products)


def _bwd(products: List[Product], weights: bool, input_grad: bool) -> int:
    """Gradient products: a weight gradient per weighted product when the
    weights train; an input gradient unless the input is the pass's own
    and carries none; a routing sum has two operands that carry
    gradients, but its first pass's couplings are constant."""
    n = 0
    for macs, weighted, first, first_pass in products:
        if weighted:
            n += 2 * macs * (int(weights) + int(input_grad or not first))
        else:
            n += 2 * macs * (1 if first_pass else 2)
    return n


def train_step_flops(d: dict, b: int) -> int:
    """One training step: G forward; per D the real, wrong and detached
    fake passes with their weight gradients (the wrong pass's class output
    is read by no loss); then per D a pass on the fakes with input
    gradients only, and G's backward."""
    g = generator_products(d, b, True, d['g_cap'])
    n = _fwd(g) + _bwd(g, True, False)
    for size in d['sizes']:
        full = discriminator_products(d, b, size, True)
        no_cls = discriminator_products(d, b, size, False)
        n += 3 * _fwd(full) + 2 * _bwd(full, True, False) \
            + _bwd(no_cls, True, False)
        n += _fwd(full) + _bwd(full, False, True)
    return n


def sample_call_flops(d: dict, b: int, cap: bool) -> int:
    """One eval-mode generator forward over ``b`` rows."""
    return _fwd(generator_products(d, b, False, cap))


# ------------------------------------------------- capsule layers' least
# time. A frozen copy of chip_smoke.py's ``_k1_work`` / ``_k2_work`` (the
# factored form at in_length 8, the votes form otherwise) and of its
# bounds: the votes form's products run as 3xTF32 on the tensor cores, the
# rest at the float32 peak; each launch takes at least the larger of its
# operations and its bytes over the peaks.

def _k1_work(shape, factored, iters):
    b, i, l_, j, o = shape
    nbytes = 4 * (b * i * l_ + j * o * l_ + b * j * o)
    if factored:
        return [(iters * b * ((4 * l_ + 3) * i * j + (4 * o * l_ + 3 * o) * j),
                 F32_FLOPS)], nbytes
    product = 2 * b * i * l_ * j * o
    routing = iters * b * (4 * i * j * o + 3 * i * j + 3 * j * o)
    return [(3 * product, TF32_FLOPS), (routing, F32_FLOPS)], nbytes


def _k2_work(shape, factored, iters, need_dw=True):
    b, i, l_, j, o = shape
    nbytes = 4 * (2 * b * i * l_ + (2 if need_dw else 1) * j * o * l_
                  + b * j * o)
    if factored:
        fwd = _k1_work(shape, True, iters)[0][0][0]
        rev = iters * b * ((10 * l_ + 6) * i * j + 8 * o * l_ * j)
        dw = 2 * (2 * iters - 1) * b * j * o * l_ if need_dw else 0
        return [(fwd + rev + dw, F32_FLOPS)], nbytes
    products = (6 if need_dw else 4) * b * i * l_ * j * o
    routing = iters * b * (10 * i * j * o + 9 * i * j + 9 * j * o)
    return [(3 * products, TF32_FLOPS), (routing, F32_FLOPS)], nbytes


def _least_s(parts, nbytes) -> float:
    return max(sum(f / p for f, p in parts), nbytes / HBM_BYTES)


def capsule_launches(d: dict, b: int, train: bool, cap_g: bool
                     ) -> Dict[str, Tuple[tuple, int]]:
    """The capsule layers a step (or a sampler call) runs, from the model's
    structure: name -> (shape (B, I, L, J, O), launches). Training: G's
    head forward and backward once; each D's class head forward in all
    four passes, backward in the real and fake passes (weights and inputs)
    and in the pass on the fakes for G (inputs only)."""
    out = {}
    if cap_g:
        g_head = (b, -(-(d['c_dim'] + d['z']) // 8), 8, d['gf'] * 16, 32)
        out['K1-G'] = (g_head, 1)
        if train:
            out['K2-G'] = (g_head, 1)
    if train and d['d_cap']:
        nd = len(d['sizes'])
        d_head = (b, 16, 8 * d['df'], d['entity'] + 1, 16)
        out['K1-D'] = (d_head, 4 * nd)
        out['K2-D'] = (d_head, 2 * nd)
        out['K2-D dx'] = (d_head, nd)
    return out


def capsule_least_s(d: dict, b: int, train: bool, cap_g: bool) -> float:
    """The capsule layers' least time a step (or a call), in seconds."""
    total = 0.0
    for name, (shape, n) in capsule_launches(d, b, train, cap_g).items():
        factored = shape[2] == 8
        if name.startswith('K1'):
            parts, nbytes = _k1_work(shape, factored, d['iters'])
        else:
            parts, nbytes = _k2_work(shape, factored, d['iters'],
                                     need_dw=not name.endswith('dx'))
        total += n * _least_s(parts, nbytes)
    return total
