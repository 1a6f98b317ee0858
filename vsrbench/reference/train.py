"""Plain fp32 training steps of the reference: FRVSR's (pixel and warping
losses) and TecoGAN's (ping-pong, STNet with the adaptive vote, VGG19
features, the generator's losses against the updated discriminator), with
a plain Adam.

The order of a TecoGAN step follows the published recipe
(``codes/models/vsrgan_model.py``): the generator runs once; the
discriminator sees the real and the (detached) fake input, and updates
first, only where the vote's distance is under the threshold; the
generator's losses are then taken against the updated discriminator. Run
with TF32 off (``no_tf32``).
"""

from __future__ import annotations

import contextlib

import torch

from .ops import (bce_logits, bd_degrade, bicubic_up, charbonnier,
                  stnet_input, warp)


@contextlib.contextmanager
def no_tf32():
    """fp32 products in fp32: TF32 off for cuDNN and matmuls, restored."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


class Adam:
    """Adam with bias correction, eps outside the square root, no weight
    decay, over a name -> parameter dict."""

    def __init__(self, params: dict, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.params, self.lr, self.betas, self.eps = params, lr, betas, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict):
        self.t += 1
        b1, b2 = self.betas
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            mhat = self.m[k] / (1 - b1 ** self.t)
            vhat = self.v[k] / (1 - b2 ** self.t)
            p.sub_(self.lr * mhat / (vhat.sqrt() + self.eps))


def trainable(net) -> dict:
    return {k: p for k, p in net.named_parameters()}


def _prepare(gt_u8: torch.Tensor, scale: int, sigma: float):
    """uint8 (n, t, H, W, c) GT with the BD border -> fp32 (n, t, c, .., ..)
    cropped GT and its BD LR."""
    n, t, hh, ww, c = gt_u8.shape
    x = gt_u8.float().div(255.0).permute(0, 1, 4, 2, 3).reshape(
        n * t, c, hh, ww)
    gt, lr = bd_degrade(x, scale, sigma)
    return (gt.reshape(n, t, c, *gt.shape[-2:]),
            lr.reshape(n, t, c, *lr.shape[-2:]))


def _warp_loss(prev, cur, lr_flow):
    return charbonnier(warp(prev, lr_flow.permute(0, 2, 3, 1)), cur)


def frvsr_step(g, adam_g: Adam, gt_u8, cfg: dict) -> tuple:
    """One FRVSR step in place. Returns (losses, G's gradients). The batch
    runs in blocks of ``clip_block`` clips (both losses are means over the
    clips, so each block's terms and gradients are weighted by its share
    of the batch and summed), so that an fp32 step of a large batch fits."""
    n = gt_u8.shape[0]
    block = cfg.get("clip_block", 128)
    params = adam_g.params
    grads = {k: torch.zeros_like(p) for k, p in params.items()}
    l_pix = l_warp = 0.0
    for k in range(0, n, block):
        part = gt_u8[k:k + block]
        share = part.shape[0] / n
        gt, lr = _prepare(part, cfg["scale"], cfg["sigma"])
        hr, _, lr_flow, prev, cur = g.forward_sequence(lr)
        lp = share * cfg["pixel_weight"] * charbonnier(hr, gt)
        lw = share * cfg["warping_weight"] * _warp_loss(prev, cur, lr_flow)
        for name, gr in zip(params, torch.autograd.grad(
                lp + lw, list(params.values()))):
            grads[name] += gr
        l_pix, l_warp = l_pix + lp.detach(), l_warp + lw.detach()
        del hr, lr_flow, prev, cur, lp, lw
    adam_g.step(grads)
    return {"l_pix_G": l_pix, "l_warp_G": l_warp}, grads


def _dbl(x):
    """Ping-pong doubling along time: frames 0..t-1, t-2..0."""
    return torch.cat([x, x.flip(1)[:, 1:]], 1)


def _feature_loss(vgg, hr, gt_unique, te: int, layers, block: int):
    """The cosine feature loss of VGG19's taps between HR frames (n, T, c,
    H, W; T = 2*te - 1, ping-pong) and the te unique GT frames (n, te, c,
    H, W), and its gradient with respect to hr, in blocks of ``block``
    frames. Returns (loss, d loss / d hr)."""
    n, t_all, c, hh, ww = hr.shape
    src = [j if j < te else 2 * te - 2 - j for j in range(t_all)]
    gt_idx = torch.tensor([b * te + src[j] for b in range(n)
                           for j in range(t_all)], device=hr.device)
    gt_flat = gt_unique.reshape(n * te, c, hh, ww)
    with torch.no_grad():
        parts = [vgg(gt_flat[k:k + block], layers)
                 for k in range(0, n * te, block)]
        gt_feats = [torch.cat(p) for p in zip(*parts)]
    del parts
    counts = [n * t_all * f.shape[-2] * f.shape[-1] for f in gt_feats]
    frames = hr.detach().reshape(n * t_all, c, hh, ww)
    grad = torch.zeros_like(frames)
    sums = [0.0] * len(layers)
    for k in range(0, n * t_all, block):
        x = frames[k:k + block].clone().requires_grad_(True)
        cos = []
        for a, gf in zip(vgg(x, layers), gt_feats):
            b = gf[gt_idx[k:k + block]]
            dot = (a * b).sum(1)
            na = torch.clamp(a.norm(dim=1), min=1e-8)
            nb = torch.clamp(b.norm(dim=1), min=1e-8)
            cos.append((dot / (na * nb)).sum())
        part = -sum(cs / cnt for cs, cnt in zip(cos, counts))
        part.backward(inputs=[x])
        grad[k:k + block] = x.grad
        sums = [s + cs.detach() for s, cs in zip(sums, cos)]
    loss = sum(1.0 - s / cnt for s, cnt in zip(sums, counts))
    return loss, grad.reshape(hr.shape)


def tecogan_step(g, d, vgg, adam_g: Adam, adam_d: Adam, gt_u8,
                 cfg: dict, update_d: bool | None = None) -> tuple:
    """One TecoGAN step in place. Returns (losses, G's gradients, D's
    gradients or None where D's update was skipped). ``update_d`` None:
    the vote decides (distance under the threshold); True or False: D
    updates or not as given (to follow another run's branch)."""
    s, te = cfg["scale"], gt_u8.shape[1]
    gt, lr = _prepare(gt_u8, s, cfg["sigma"])
    n, _, c, lh, lw = lr.shape
    with torch.no_grad():
        bi = bicubic_up(lr.reshape(n * te, c, lh, lw), s).reshape(
            n, te, c, s * lh, s * lw)
    gt_unique = gt
    lr, gt, bi = _dbl(lr), _dbl(gt), _dbl(bi)
    hr, hr_flow, lr_flow, prev, cur = g.forward_sequence(lr)
    size, ratio = cfg["d_size"], cfg["crop_border_ratio"]
    with torch.no_grad():
        x_real = stnet_input(gt, bi, hr_flow, ratio, size)
    x_fake = stnet_input(hr, bi, hr_flow, ratio, size)

    real_logits, _ = d(x_real)
    fake_logits, _ = d(x_fake.detach())
    loss_d = bce_logits(real_logits, True) + bce_logits(fake_logits, False)
    with torch.no_grad():
        distance = (torch.log(torch.sigmoid(real_logits) + 1e-8).mean()
                    - torch.log(torch.sigmoid(fake_logits) + 1e-8).mean())
    grads_d = None
    losses = {"distance": distance,
              "l_gan_D": torch.zeros((), device=hr.device)}
    if update_d is None:
        update_d = bool(distance < cfg["update_threshold"])
    if update_d:
        pd = adam_d.params
        grads_d = dict(zip(pd, torch.autograd.grad(loss_d,
                                                   list(pd.values()))))
        adam_d.step(grads_d)
        losses["l_gan_D"] = loss_d.detach()
    del loss_d, real_logits, fake_logits

    l_pix = cfg["pixel_weight"] * charbonnier(hr, gt)
    l_warp = cfg["warping_weight"] * _warp_loss(prev, cur, lr_flow)
    l_pp = cfg["pingpong_weight"] * charbonnier(hr[:, :te - 1],
                                                hr[:, te:].flip(1))
    fake_g_logits, _ = d(x_fake)
    l_gan = cfg["gan_weight"] * bce_logits(fake_g_logits, True)
    l_feat, feat_grad = _feature_loss(vgg, hr, gt_unique, te,
                                      tuple(cfg["feature_layers"]),
                                      cfg.get("vgg_block", 64))
    rest = l_pix + l_warp + l_pp + l_gan
    pg = adam_g.params
    fw = cfg["feature_weight"]
    grads_g = dict(zip(pg, torch.autograd.grad(
        [rest, hr], list(pg.values()),
        grad_outputs=[torch.ones_like(rest), fw * feat_grad])))
    adam_g.step(grads_g)
    losses.update({"l_pix_G": l_pix.detach(), "l_warp_G": l_warp.detach(),
                   "l_feat_G": fw * l_feat, "l_pp_G": l_pp.detach(),
                   "l_gan_G": l_gan.detach()})
    return losses, grads_g, grads_d
