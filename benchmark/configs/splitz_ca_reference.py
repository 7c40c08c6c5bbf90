"""Plain PyTorch reference of the split-z capsule CA GAN and its training
step: the generator (CA_NET, VC_NET, the capsule or linear first stage, the
next stage, the toRGB heads), the joint discriminators with their capsule
or linear class heads, the losses, the step's three phases and Adam.

It follows the published model (Multimodal-Group/Text2img_EKL: model.py's
CondGNetCatZCA and JOINT_D_NET64/128, cub_trainer_splitz_cap_ca.py's
train step) and reads only the configuration's dict (the YAML's nested
keys). Parameter names are the published model's ``state_dict`` keys, so
the same weights reach any implementation that keeps them. Everything is
float32 with TF32 off; ``Precision`` rounds the operands of every product
(convolutions, linears, capsule votes and routing sums) where a lower
precision is asked for, as the control of the benchmark's comparison.

Departures from the published code, each as the measured program has it:
  * BatchNorm in train mode normalises with the batch's biased variance
    (as torch does); its running statistics are not tracked here, since
    no train-mode pass reads them (eval mode reads the given buffers).
  * The D class head's capsule norm adds 1e-12 under the square root and
    the squash adds 1e-8 under its root, as the measured program does.
  * LeakyReLU's slope is 0.2 in float32 (the measured program rounds it
    to bfloat16 under its bfloat16 policy).
  * Adam is the textbook update with bias correction, lr 2e-4, betas
    (0.5, 0.999), eps 1e-8 added to the corrected root.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

CAPSULE_LENGTH = 8
BN_EPS = 1e-5
BETAS = (0.5, 0.999)
ADAM_EPS = 1e-8


# ---------------------------------------------------------------- shapes

def dims(cfg: dict) -> dict:
    """The sizes the networks are built from."""
    gan, train = cfg['GAN'], cfg['TRAIN']
    tree = cfg.get('TREE', {})
    branches = int(tree.get('BRANCH_NUM', 3))
    base = int(tree.get('BASE_SIZE', 64))
    ef = int(gan['EMBEDDING_DIM'])
    manifd = int(gan.get('MANIFD_DIM', 128))
    cat = train.get('CAT_Z', 'concat')
    return dict(
        text=int(cfg.get('TEXT', {}).get('DIMENSION', 1024)),
        z=int(gan['Z_DIM']), ef=ef, manifd=manifd,
        entity=int(gan.get('ENTITY_DIM', 200)),
        gf=int(gan['GF_DIM']), df=int(gan['DF_DIM']),
        r_num=int(gan.get('R_NUM', 2)), branches=branches,
        sizes=[base * 2 ** i for i in range(branches)],
        c_dim=ef + manifd if cat == 'concat' else ef,
        d_cond=ef + manifd if cat == 'concat' else ef,
        g_cap=bool(train.get('G_CAPSULE', False)),
        d_cap=bool(train.get('D_CAPSULE', False)),
        iters=int(cfg.get('TPU_CAPSULE_ITERATIONS', 3)))


def _bn(name: str, n: int, out: list) -> None:
    out += [(name + '.weight', (n,), 'bn_weight'),
            (name + '.bias', (n,), 'zero'),
            (name + '.running_mean', (n,), 'zero'),
            (name + '.running_var', (n,), 'one')]


def g_spec(cfg: dict, eval_build: bool = False) -> List[tuple]:
    """(name, shape, init) of every generator tensor, in ``state_dict``
    order. ``eval_build`` takes the first stage's kind from TEST.G_CAPSULE,
    as the sampling build does."""
    d = dims(cfg)
    cap = cfg.get('TEST', {}).get('G_CAPSULE', False) if eval_build \
        else d['g_cap']
    ngf, ef = d['gf'] * 16, d['ef']
    s: list = [('ca_net1.fc.weight', (ef * 4, d['text']), 'weight'),
               ('ca_net1.fc.bias', (ef * 4,), 'zero'),
               ('vc_net2.fc1.weight', (512, d['z'] + d['entity']), 'weight'),
               ('vc_net2.fc1.bias', (512,), 'zero')]
    _bn('vc_net2.bn_fc1', 512, s)
    s += [('vc_net2.fc2.weight', (256, 512), 'weight'),
          ('vc_net2.fc2.bias', (256,), 'zero')]
    _bn('vc_net2.bn_fc2', 256, s)
    for k in ('31', '32'):
        s += [('vc_net2.fc%s.weight' % k, (d['manifd'], 256), 'weight'),
              ('vc_net2.fc%s.bias' % k, (d['manifd'],), 'zero')]
    in_dim = d['c_dim'] + d['z']
    if cap:
        s.append(('h_net1.fc_cap.1.weight',
                  (ngf, 32, CAPSULE_LENGTH), 'weight'))
        _bn('h_net1.fc_cap.3', ngf * 32, s)
    else:
        s.append(('h_net1.fc.0.weight', (ngf * 32, in_dim), 'weight'))
        _bn('h_net1.fc.1', ngf * 32, s)
    for k in range(1, 5):
        cin, cout = ngf // 2 ** (k - 1), ngf // 2 ** k
        s.append(('h_net1.upsample%d.1.weight' % k, (2 * cout, cin, 3, 3),
                  'weight'))
        _bn('h_net1.upsample%d.2' % k, 2 * cout, s)
    s.append(('img_net1.img.0.weight', (3, d['gf'], 3, 3), 'weight'))
    ngf = d['gf']
    for stage in range(2, d['branches'] + 1):
        p = 'h_net%d.' % stage
        s.append((p + 'jointConv.0.weight', (2 * ngf, ngf + d['c_dim'], 3, 3),
                  'weight'))
        _bn(p + 'jointConv.1', 2 * ngf, s)
        for r in range(d['r_num']):
            q = p + 'residual.%d.block.' % r
            s.append((q + '0.weight', (2 * ngf, ngf, 3, 3), 'weight'))
            _bn(q + '1', 2 * ngf, s)
            s.append((q + '3.weight', (ngf, ngf, 3, 3), 'weight'))
            _bn(q + '4', ngf, s)
        s.append((p + 'upsample.1.weight', (ngf, ngf, 3, 3), 'weight'))
        _bn(p + 'upsample.2', ngf, s)
        ngf //= 2
        s.append(('img_net%d.img.0.weight' % stage, (3, ngf, 3, 3),
                  'weight'))
    return s


def d_spec(cfg: dict, size: int) -> List[tuple]:
    """(name, shape, init) of every tensor of the joint D at ``size`` px."""
    d = dims(cfg)
    ndf = d['df']
    s: list = [('img_code_s16.0.weight', (ndf, 3, 4, 4), 'weight')]
    for conv, bn, k in ((2, 3, 1), (5, 6, 2), (8, 9, 4)):
        s.append(('img_code_s16.%d.weight' % conv, (ndf * k * 2, ndf * k, 4, 4),
                  'weight'))
        _bn('img_code_s16.%d' % bn, ndf * k * 2, s)
    if size == 128:
        s.append(('img_code_s32.0.weight', (ndf * 16, ndf * 8, 4, 4),
                  'weight'))
        _bn('img_code_s32.1', ndf * 16, s)
        s.append(('img_code_s32_1.0.weight', (ndf * 8, ndf * 16, 3, 3),
                  'weight'))
        _bn('img_code_s32_1.1', ndf * 8, s)
    s.append(('jointConv.0.weight', (ndf * 8, ndf * 8 + d['d_cond'], 3, 3),
              'weight'))
    _bn('jointConv.1', ndf * 8, s)
    for head in ('logits', 'uncond_logits'):
        s += [(head + '.0.weight', (1, ndf * 8, 4, 4), 'weight'),
              (head + '.0.bias', (1,), 'fan_in_bias')]
    if d['d_cap']:
        s.append(('fc_ac_cap.0.weight', (d['entity'] + 1, 16, ndf * 8),
                  'weight'))
    else:
        s += [('fc_ac.weight', (d['entity'] + 1, ndf * 8 * 16), 'weight'),
              ('fc_ac.bias', (d['entity'] + 1,), 'zero')]
    return s


def spec(cfg: dict, eval_build: bool = False) -> Dict[str, List[tuple]]:
    """Every network's tensors: 'G', then 'D0', 'D1', ... (training only)."""
    out = {'G': g_spec(cfg, eval_build)}
    if not eval_build:
        for i, size in enumerate(dims(cfg)['sizes']):
            out['D%d' % i] = d_spec(cfg, size)
    return out


def make_weights(cfg: dict, gen: torch.Generator, device,
                 eval_build: bool = False) -> Dict[str, Dict[str, torch.Tensor]]:
    """Every network's tensors, float32 on ``device``, from one normal draw
    of ``gen``: weights at the spread of an orthogonal init
    (1/sqrt(max(rows, columns))), BatchNorm scales N(1, 0.02), the logit
    biases at 1/sqrt(fan_in), zero biases and means, unit variances."""
    nets = spec(cfg, eval_build)
    drawn = [shape for s in nets.values() for _, shape, init in s
             if init in ('weight', 'bn_weight', 'fan_in_bias')]
    flat = torch.randn(sum(math.prod(s) for s in drawn), generator=gen,
                       device=device)
    out, off = {}, 0
    for net, tensors in nets.items():
        out[net] = {}
        for name, shape, init in tensors:
            if init == 'zero':
                out[net][name] = torch.zeros(shape, device=device)
                continue
            if init == 'one':
                out[net][name] = torch.ones(shape, device=device)
                continue
            n = math.prod(shape)
            x = flat[off:off + n].view(shape)
            off += n
            if init == 'weight':
                x = x * (1.0 / math.sqrt(max(shape[0], n // shape[0])))
            elif init == 'bn_weight':
                x = 1.0 + 0.02 * x
            else:  # the logit heads' bias: fan-in 16 x 8ndf
                x = x * (1.0 / math.sqrt(16 * 8 * dims(cfg)['df']))
            out[net][name] = x
    return out


# ------------------------------------------------------------- precision

class Precision:
    """Rounds the operands of every product: 'float32' leaves them, 'fp8'
    scales each operand tensor to the e4m3 range by its largest magnitude
    and rounds it to float8_e4m3fn and back, as a per-tensor scaled fp8
    product would see it; gradients are not rounded."""

    def __init__(self, name: str = 'float32'):
        if name not in ('float32', 'fp8'):
            raise ValueError('unknown precision %r' % name)
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == 'float32':
            return x
        with torch.no_grad():
            scale = 448.0 / x.abs().amax().clamp(min=1e-30)
            q = (x * scale).to(torch.float8_e4m3fn).float() / scale
        # the forward sees the rounded operand; the gradient passes as is
        return x + (q - x).detach()


F32 = Precision('float32')


# ----------------------------------------------------------------- layers

def conv(x, w, stride, pad, prec, bias=None):
    return F.conv2d(prec(x), prec(w), bias, stride, pad)


def linear(x, w, b, prec):
    return F.linear(prec(x), prec(w), b)


def bn(x, P, name, train):
    if train:
        return F.batch_norm(x, None, None, P[name + '.weight'],
                            P[name + '.bias'], True, 0.0, BN_EPS)
    return F.batch_norm(x, P[name + '.running_mean'],
                        P[name + '.running_var'], P[name + '.weight'],
                        P[name + '.bias'], False, 0.0, BN_EPS)


def glu(x):
    n = x.shape[1] // 2
    return x[:, :n] * torch.sigmoid(x[:, n:])


def lrelu(x):
    return F.leaky_relu(x, 0.2)


def squash(s):
    s2 = (s * s).sum(-1, keepdim=True)
    return s * (s2 / (1.0 + s2) * torch.rsqrt(s2 + 1e-8))


def capsule(x, w, iters, prec):
    """Shared-weight capsule layer with dynamic routing: x [B, I, L],
    w [J, O, L] -> v [B, J, O]."""
    u = torch.einsum('bil,jol->bijo', prec(x), prec(w))
    logits = u.new_zeros(u.shape[:3])
    v = None
    for r in range(iters):
        c = torch.softmax(logits, dim=2)
        v = squash(torch.einsum('bij,bijo->bjo', prec(c), prec(u)))
        if r < iters - 1:
            logits = logits + torch.einsum('bijo,bjo->bij', prec(u), prec(v))
    return v


def tile(c, h):
    return c[:, :, None, None].expand(-1, -1, h.shape[2], h.shape[3])


# ------------------------------------------------------------------ nets

def generator(P, d, noise, txt, cls_onehot, eps, eps_cls, train, prec,
              cls_prior=None, cap=None):
    """-> ([images per stage, NCHW in [-1, 1]], mu1, logvar1, mu2, logvar2).
    In eval mode with ``cls_prior`` the class code is the prior."""
    cap = d['g_cap'] if cap is None else cap
    ef = d['ef']
    x = glu(linear(txt, P['ca_net1.fc.weight'], P['ca_net1.fc.bias'], prec))
    mu1, lv1 = x[:, :ef], x[:, ef:]
    c1 = eps * torch.exp(0.5 * lv1) + mu1
    if cls_prior is None:
        h = torch.cat([noise, cls_onehot], dim=1)
        h = torch.relu(bn(linear(h, P['vc_net2.fc1.weight'],
                                 P['vc_net2.fc1.bias'], prec), P,
                          'vc_net2.bn_fc1', train))
        h = torch.relu(bn(linear(h, P['vc_net2.fc2.weight'],
                                 P['vc_net2.fc2.bias'], prec), P,
                          'vc_net2.bn_fc2', train))
        mu2 = linear(h, P['vc_net2.fc31.weight'], P['vc_net2.fc31.bias'],
                     prec)
        lv2 = linear(h, P['vc_net2.fc32.weight'], P['vc_net2.fc32.bias'],
                     prec)
        c2 = eps_cls * torch.exp(0.5 * lv2) + mu2
    else:
        c2 = cls_prior
        mu2 = lv2 = torch.zeros_like(c2)
    c = torch.cat([c1, c2], dim=1)
    z = torch.cat([c, noise], dim=1)
    b, ngf = z.shape[0], d['gf'] * 16
    if cap:
        z = F.pad(z, (0, (-z.shape[1]) % CAPSULE_LENGTH))
        v = capsule(z.reshape(b, -1, CAPSULE_LENGTH),
                    P['h_net1.fc_cap.1.weight'], d['iters'], prec)
        h = glu(bn(v.reshape(b, -1), P, 'h_net1.fc_cap.3', train))
    else:
        h = glu(bn(linear(z, P['h_net1.fc.0.weight'], None, prec), P,
                   'h_net1.fc.1', train))
    h = h.reshape(b, ngf, 4, 4)
    for k in range(1, 5):
        h = F.interpolate(h, scale_factor=2, mode='nearest')
        h = glu(bn(conv(h, P['h_net1.upsample%d.1.weight' % k], 1, 1, prec),
                   P, 'h_net1.upsample%d.2' % k, train))
    codes = [h]
    for stage in range(2, d['branches'] + 1):
        p = 'h_net%d.' % stage
        h = codes[-1]
        h = glu(bn(conv(torch.cat([tile(c, h), h], 1),
                        P[p + 'jointConv.0.weight'], 1, 1, prec), P,
                   p + 'jointConv.1', train))
        for r in range(d['r_num']):
            q = p + 'residual.%d.block.' % r
            y = glu(bn(conv(h, P[q + '0.weight'], 1, 1, prec), P, q + '1',
                       train))
            y = bn(conv(y, P[q + '3.weight'], 1, 1, prec), P, q + '4', train)
            h = y + h
        h = F.interpolate(h, scale_factor=2, mode='nearest')
        h = glu(bn(conv(h, P[p + 'upsample.1.weight'], 1, 1, prec), P,
                   p + 'upsample.2', train))
        codes.append(h)
    imgs = [torch.tanh(conv(h, P['img_net%d.img.0.weight' % (k + 1)], 1, 1,
                            prec)) for k, h in enumerate(codes)]
    return imgs, mu1, lv1, mu2, lv2


def discriminator(P, d, x, c, size, prec):
    """-> (sentence match [B], reality [B], class log-probs [B, K+1])."""
    h = lrelu(conv(x, P['img_code_s16.0.weight'], 2, 1, prec))
    for cv, b_ in ((2, 3), (5, 6), (8, 9)):
        h = lrelu(bn(conv(h, P['img_code_s16.%d.weight' % cv], 2, 1, prec),
                     P, 'img_code_s16.%d' % b_, True))
    if size == 128:
        h = lrelu(bn(conv(h, P['img_code_s32.0.weight'], 2, 1, prec), P,
                     'img_code_s32.1', True))
        h = lrelu(bn(conv(h, P['img_code_s32_1.0.weight'], 1, 1, prec), P,
                     'img_code_s32_1.1', True))
    j = lrelu(bn(conv(torch.cat([tile(c, h), h], 1), P['jointConv.0.weight'],
                      1, 1, prec), P, 'jointConv.1', True))
    sen = torch.sigmoid(conv(j, P['logits.0.weight'], 4, 0, prec,
                             P['logits.0.bias'])).reshape(-1)
    real = torch.sigmoid(conv(h, P['uncond_logits.0.weight'], 4, 0, prec,
                              P['uncond_logits.0.bias'])).reshape(-1)
    b = h.shape[0]
    if d['d_cap']:
        caps = h.permute(0, 2, 3, 1).reshape(b, 16, d['df'] * 8)
        out = capsule(caps, P['fc_ac_cap.0.weight'], d['iters'], prec)
        cp = torch.log_softmax(torch.sqrt((out * out).sum(-1) + 1e-12), -1)
    else:
        cp = torch.log_softmax(linear(h.reshape(b, -1), P['fc_ac.weight'],
                                      P['fc_ac.bias'], prec), -1)
    return sen, real, cp


# ------------------------------------------------------------------ losses

def bce(p, t):
    return F.binary_cross_entropy(p, t)


def ce(logq, p):
    return -(p * logq).sum() / p.shape[0]


def kl(mu, lv):
    return -0.5 * torch.mean(1.0 + lv - mu * mu - torch.exp(lv))


# ------------------------------------------------------------------- step

class Adam:
    """Textbook Adam over a dict of leaves, updated in place."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float):
        self.params, self.lr, self.t = params, lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        b1, b2 = BETAS
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, g in grads.items():
            m, v = self.m[k], self.v[k]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            self.params[k].sub_(self.lr * (m / c1)
                                / (torch.sqrt(v / c2) + ADAM_EPS))


def trainable(P: Dict[str, torch.Tensor]) -> List[str]:
    return [k for k in P if not k.endswith(('running_mean', 'running_var'))]


class TrainStep:
    """The split-z step on float32 leaves: one G forward (graph kept), per
    D three passes (real, wrong, detached fake) on the detached fused mu,
    errD, its backward and Adam; then G's loss through the updated Ds, its
    backward and Adam. ``grads[net]`` keeps the last step's gradients."""

    def __init__(self, cfg: dict, weights: Dict[str, Dict[str, torch.Tensor]],
                 prec: Precision = F32):
        self.d = dims(cfg)
        self.prec = prec
        coeff = cfg['TRAIN'].get('COEFF', {})
        self.uncond = float(coeff.get('UNCOND_LOSS', 0.0))
        self.kl = float(coeff.get('KL', 2.0))
        if float(coeff.get('COLOR_LOSS', 0.0)) > 0:
            raise NotImplementedError('the colour loss is not in the '
                                      'reference')
        self.P = {net: {k: v.clone() for k, v in w.items()}
                  for net, w in weights.items()}
        self.ds = [n for n in self.P if n.startswith('D')]
        lr_g = float(cfg['TRAIN'].get('GENERATOR_LR', 2e-4))
        lr_d = float(cfg['TRAIN'].get('DISCRIMINATOR_LR', 2e-4))
        self.opt = {n: Adam({k: self.P[n][k] for k in trainable(self.P[n])},
                            lr_g if n == 'G' else lr_d) for n in self.P}
        self.grads: Dict[str, Dict[str, torch.Tensor]] = {}

    def _leaves(self, net):
        return {k: self.P[net][k].requires_grad_(True)
                for k in trainable(self.P[net])}

    @staticmethod
    def _grad(loss, leaves, acc, retain=False):
        """Add d loss / d leaves into ``acc``."""
        names = list(leaves)
        for k, g in zip(names, torch.autograd.grad(
                loss, [leaves[k] for k in names], retain_graph=retain,
                allow_unused=True)):
            if g is not None:
                acc[k] = g if k not in acc else acc[k] + g

    def __call__(self, batch: dict, draws: dict) -> Dict[str, float]:
        """One step. A D's loss is a sum over its three passes, each with
        its own batch statistics, so each pass's part is differentiated
        on its own and the parts summed: the same gradient, with one D
        graph alive at a time. G's loss is taken back through each updated
        D to the fakes and the fused mu, D by D; then G runs forward again,
        now keeping its graph, and takes those gradients back: G's graph
        is never alive beside a D's."""
        d, prec = self.d, self.prec
        real = [x.float() / 127.5 - 1.0 for x in batch['real']]
        wrong = [x.float() / 127.5 - 1.0 for x in batch['wrong']]
        real_cp = batch['real_cp']
        bsz = real_cp.shape[0]
        dev = real_cp.device
        ones, zeros = torch.ones(bsz, device=dev), torch.zeros(bsz, device=dev)
        fake_cp = torch.zeros_like(real_cp)
        fake_cp[:, -1] = 1.0
        u = self.uncond
        for n in self.P:
            for v in self.P[n].values():
                v.requires_grad_(False)

        def g_forward():
            return generator(self.P['G'], d, draws['noise'], batch['txt'],
                             batch['cls_onehot'], draws['eps'],
                             draws['eps_cls'], True, prec)

        with torch.no_grad():
            imgs, mu1, lv1, mu2, lv2 = g_forward()
        mu_sg = torch.cat([mu1, mu2], 1)
        err_d = 0.0
        for i, n in enumerate(self.ds):
            size = d['sizes'][i]
            leaves = self._leaves(n)
            P = self.P[n]
            grads: Dict[str, torch.Tensor] = {}
            for x, match, uncond, cls in (
                    (real[i], ones, ones, real_cp),
                    (wrong[i], zeros, ones, None),
                    (imgs[i], zeros, zeros, fake_cp)):
                o = discriminator(P, d, x, mu_sg, size, prec)
                if u > 0:
                    loss = bce(o[0], match) + u * bce(o[1], uncond)
                    if cls is not None:
                        loss = loss + ce(o[2], cls)
                else:  # errD = real + (wrong + fake) / 2
                    loss = bce(o[0], match) * (1.0 if cls is real_cp
                                               else 0.5)
                self._grad(loss, leaves, grads)
                err_d = err_d + float(loss.detach())
                del o, loss
            self.grads[n] = {k: grads.get(k, torch.zeros_like(v))
                             for k, v in leaves.items()}
            for v in leaves.values():
                v.requires_grad_(False)
            self.opt[n].step(self.grads[n])
        seeds = []
        err_g = 0.0
        for i, n in enumerate(self.ds):
            x = imgs[i].requires_grad_(True)
            c = mu_sg.clone().requires_grad_(True)
            o = discriminator(self.P[n], d, x, c, d['sizes'][i], prec)
            loss = bce(o[0], ones)
            if u > 0:
                loss = loss + u * bce(o[1], ones) + ce(o[2], real_cp)
            seeds += list(torch.autograd.grad(loss, [x, c]))
            err_g = err_g + float(loss.detach())
            del o, loss
        del imgs
        g_leaves = self._leaves('G')
        imgs, mu1, lv1, mu2, lv2 = g_forward()
        mu = torch.cat([mu1, mu2], 1)
        kl_part = (kl(mu1, lv1) + kl(mu2, lv2)) * self.kl
        err_g = err_g + float(kl_part.detach())
        outs = [kl_part]
        seeds.insert(0, torch.ones_like(kl_part))
        for i in range(len(self.ds)):
            outs += [imgs[i], mu]
        grads = {}
        names = list(g_leaves)
        for k, g in zip(names, torch.autograd.grad(
                outs, [g_leaves[k] for k in names], seeds,
                allow_unused=True)):
            if g is not None:
                grads[k] = g
        self.grads['G'] = {k: grads.get(k, torch.zeros_like(v))
                           for k, v in g_leaves.items()}
        for v in g_leaves.values():
            v.requires_grad_(False)
        self.opt['G'].step(self.grads['G'])
        return {'errD': err_d, 'errG': err_g}


@torch.no_grad()
def sample(cfg: dict, P: Dict[str, torch.Tensor], noise, emb, cls_prior, eps,
           prec: Precision = F32) -> torch.Tensor:
    """The eval-mode caption sampler: emb [C, B, E], noise [B, Z] shared by
    the C captions, cls_prior and eps [C, B, .] -> the top stage's uint8
    images [C, B, H, W, 3] (pixels truncated from (x + 1) * 127.5)."""
    d = dims(cfg)
    n_cap, bsz = emb.shape[:2]
    cap = bool(cfg.get('TEST', {}).get('G_CAPSULE', False))
    fold = lambda t: t.reshape(n_cap * bsz, *t.shape[2:])  # noqa: E731
    noise = noise.unsqueeze(0).expand(n_cap, *noise.shape)
    imgs = generator(P, d, fold(noise), fold(emb), None, fold(eps), None,
                     False, prec, cls_prior=fold(cls_prior), cap=cap)[0]
    img = torch.clamp((imgs[-1] + 1.0) * 127.5, 0, 255).to(torch.uint8)
    return img.permute(0, 2, 3, 1).reshape(n_cap, bsz, *img.shape[2:],
                                           3)


def reference_mode():
    """Float32 products without TF32, for the duration of a block."""
    return _NoTF32()


class _NoTF32:
    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
        return False

