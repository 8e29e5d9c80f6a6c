"""Model FLOPs from shapes: 2 per multiply-add of every linear layer,
convolution and attention product (q·kᵀ and p·v), none for norms,
activations or elementwise work, as `torch.utils.flop_counter` counts a
plain forward. The per-request sums count what the edit's stages run at
their batch sizes; the text and IP keys and values of the cross-attentions
are projected once per denoising loop, as the program projects them.
"""

from __future__ import annotations

from typing import Dict

PEAK_BF16 = 989e12  # H100 SXM, dense bf16 tensor-core FLOP/s (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3


def lin(tokens: int, i: int, o: int) -> float:
    return 2.0 * tokens * i * o


def conv(b: int, cin: int, cout: int, k: int, h: int, w: int) -> float:
    """A k×k convolution with an (h, w) output."""
    return 2.0 * b * cin * cout * k * k * h * w


def attention(b: int, sq: int, sk: int, width: int) -> float:
    """q·kᵀ and p·v over all heads of total width `width`."""
    return 4.0 * b * sq * sk * width


def unet_forward(cfg, b: int, side: int, s_ctx: int, n_ip: int = 0,
                 with_cross_kv: bool = True) -> float:
    """One UNet forward at batch `b` on a side×side latent; `n_ip` IP
    tokens (0: no IP attention). `with_cross_kv=False` leaves out the
    text and IP key/value projections (see `unet_cross_kv`)."""
    ch, ted = cfg.block_out_channels, cfg.block_out_channels[0] * 4
    f = lin(b, ch[0], ted) + lin(b, ted, ted)
    if cfg.addition_embed_type == "text_time":
        f += lin(b, cfg.projection_class_embeddings_input_dim, ted) + lin(b, ted, ted)

    def resnet(cin, cout, s):
        x = conv(b, cin, cout, 3, s, s) + lin(b, ted, cout) + conv(b, cout, cout, 3, s, s)
        return x + (conv(b, cin, cout, 1, s, s) if cin != cout else 0.0)

    def xformer(c, depth, s):
        n = b * s * s
        x = 2 * lin(n, c, c)  # proj_in, proj_out
        per = 4 * lin(n, c, c) + attention(b, s * s, s * s, c)  # self-attention
        per += 2 * lin(n, c, c) + attention(b, s * s, s_ctx, c)  # cross: q, out, attention
        if with_cross_kv:
            per += 2 * lin(b * s_ctx, cfg.cross_attention_dim, c)
        if n_ip and cfg.with_ip:
            per += attention(b, s * s, n_ip, c)
            if with_cross_kv:
                per += 2 * lin(b * n_ip, cfg.cross_attention_dim, c)
        per += lin(n, c, 8 * c) + lin(n, 4 * c, c)  # geglu feed-forward
        return x + depth * per

    s = side
    f += conv(b, cfg.in_channels, ch[0], 3, s, s)
    skips, cin = [ch[0]], ch[0]
    for i, btype in enumerate(cfg.down_block_types):
        cout = ch[i]
        for j in range(cfg.layers_per_block):
            f += resnet(cin if j == 0 else cout, cout, s)
            if btype == "CrossAttnDownBlock2D":
                f += xformer(cout, cfg.transformer_layers_per_block[i], s)
            skips.append(cout)
        if i < len(ch) - 1:
            s //= 2
            f += conv(b, cout, cout, 3, s, s)
            skips.append(cout)
        cin = cout
    f += 2 * resnet(cin, cin, s) + xformer(cin, cfg.transformer_layers_per_block[-1], s)
    n = len(ch)
    for i, btype in enumerate(reversed(cfg.down_block_types)):
        cout = ch[n - 1 - i]
        for j in range(cfg.layers_per_block + 1):
            f += resnet((cin if j == 0 else cout) + skips.pop(), cout, s)
            if btype == "CrossAttnDownBlock2D":
                f += xformer(cout, cfg.transformer_layers_per_block[n - 1 - i], s)
        if i < n - 1:
            s *= 2
            f += conv(b, cout, cout, 3, s, s)
        cin = cout
    return f + conv(b, ch[0], cfg.out_channels, 3, s, s)


def unet_cross_kv(cfg, b: int, side: int, s_ctx: int, n_ip: int = 0) -> float:
    """The key/value projections of the text (and IP) context, once."""
    return (unet_forward(cfg, b, side, s_ctx, n_ip, True)
            - unet_forward(cfg, b, side, s_ctx, n_ip, False))


def _vae_mid(b: int, c: int, s: int) -> float:
    res = 2 * conv(b, c, c, 3, s, s)
    return 2 * res + 4 * lin(b * s * s, c, c) + attention(b, s * s, s * s, c)


def vae_encode(cfg, b: int, size: int) -> float:
    ch, s = cfg.block_out_channels, size
    f = conv(b, cfg.in_channels, ch[0], 3, s, s)
    cin = ch[0]
    for i, cout in enumerate(ch):
        c = cin
        for _ in range(cfg.layers_per_block):
            f += conv(b, c, cout, 3, s, s) + conv(b, cout, cout, 3, s, s)
            f += conv(b, c, cout, 1, s, s) if c != cout else 0.0
            c = cout
        if i < len(ch) - 1:
            s //= 2
            f += conv(b, cout, cout, 3, s, s)
        cin = cout
    lc = cfg.latent_channels
    return f + _vae_mid(b, cin, s) + conv(b, cin, 2 * lc, 3, s, s) + conv(b, 2 * lc, 2 * lc, 1, s, s)


def vae_decode(cfg, b: int, side: int) -> float:
    ch, s, lc = cfg.block_out_channels, side, cfg.latent_channels
    f = conv(b, lc, lc, 1, s, s) + conv(b, lc, ch[-1], 3, s, s) + _vae_mid(b, ch[-1], s)
    cin = ch[-1]
    for i, cout in enumerate(reversed(ch)):
        c = cin
        for _ in range(cfg.layers_per_block + 1):
            f += conv(b, c, cout, 3, s, s) + conv(b, cout, cout, 3, s, s)
            f += conv(b, c, cout, 1, s, s) if c != cout else 0.0
            c = cout
        if i < len(ch) - 1:
            s *= 2
            f += conv(b, cout, cout, 3, s, s)
        cin = cout
    return f + conv(b, cin, cfg.in_channels, 3, s, s)


def clip_text(cfg, b: int) -> float:
    s, d = cfg.max_positions, cfg.hidden_size
    per = 4 * lin(b * s, d, d) + attention(b, s, s, d)
    per += lin(b * s, d, cfg.intermediate_size) + lin(b * s, cfg.intermediate_size, d)
    return cfg.num_layers * per + (lin(b, d, cfg.projection_dim) if cfg.projection_dim else 0.0)


def prior_refine(cfg, b: int, output_proj: bool) -> float:
    """The prior's one-step (no diffusion) refinement of `b` embeddings,
    under CFG (2b rows), on the sequence `assemble_sequence` builds."""
    d, rows, t, f = cfg.embed_dim, 2 * b, 0, 0.0
    for name, dim in cfg.sequence_input_key:
        if name == "noisy_inputs":
            continue
        if name == "src_type":
            t += 1
            continue
        n = cfg.text_len if name == "crossattn_clip" else 1
        f += lin(rows * n, dim, d) if dim > 0 else 0.0
        t += n + 2  # start and end tokens
    t = min(t, cfg.gpt2.max_positions - cfg.sequence_gen_length)
    g = cfg.gpt2
    per = lin(rows * t, d, 3 * d) + attention(rows, t, t, d) + lin(rows * t, d, d)
    per += lin(rows * t, d, 4 * d) + lin(rows * t, 4 * d, d)
    return f + g.num_layers * per + (lin(b, d, cfg.output_dim) if output_proj else 0.0)


def image_proj(cfg, b: int) -> float:
    """The IP projection of the conditional and the zero embeddings."""
    return 2 * lin(b * cfg.num_crops, cfg.clip_embeddings_dim, cfg.num_tokens * cfg.cross_attention_dim)


def refiner_steps(refinement: float, grid: int = 50) -> int:
    return min(int(grid * refinement), grid) if refinement > 0 else 0


def edit(c: Dict, b: int, steps: int, refinement: float) -> Dict[str, float]:
    """FLOPs of the edit's stages for `b` requests run together (a served
    microbatch; `b` = 1 for a single edit), by stage."""
    side = c["image_size"] // 2 ** (len(c["vae"].block_out_channels) - 1)
    u, r = c["unet"], c["refiner"]
    s_ctx, s_ref = c["text1"].max_positions, c["text2"].max_positions
    n_ip = c["image_proj"].num_tokens
    # the null prompt is encoded once per microbatch, and once per single edit
    towers = clip_text(c["text1"], b) + clip_text(c["text2"], b)
    towers += clip_text(c["text1"], 1) + clip_text(c["text2"], 1)
    out = {
        "prior": clip_text(c["prior_text"], 1) + prior_refine(c["prior"], b, c["prior_output_proj"]),
        "prompt_encode": towers + image_proj(c["image_proj"], b),
        "vae": vae_encode(c["vae"], b, c["image_size"]) + vae_decode(c["vae"], b, side),
        "inversion": steps * unet_forward(u, b, side, s_ctx, 0, False) + unet_cross_kv(u, b, side, s_ctx),
        "denoise": steps * unet_forward(u, 2 * b, side, s_ctx, n_ip, False)
        + unet_cross_kv(u, 2 * b, side, s_ctx, n_ip),
    }
    n_ref = refiner_steps(refinement)
    if n_ref:
        out["refiner_prompt_encode"] = clip_text(c["text2"], b) + clip_text(c["text2"], 1)
        out["refiner_vae"] = vae_encode(c["vae"], b, c["image_size"]) + vae_decode(c["vae"], b, side)
        out["refiner"] = (n_ref * unet_forward(r, 2 * b, side, s_ref, 0, False)
                          + unet_cross_kv(r, 2 * b, side, s_ref))
    return out


def k1_bound_s(q_shape, k_shape, causal: bool, dtype: str) -> float:
    """Least time of one K1 call on (B, H, S, D) q and k: 4·B·H·D·pairs
    operations over the bf16 peak, or q, k, v, o moved once over HBM."""
    b, h, sq, d = q_shape
    sk = k_shape[2]
    pairs = (sum(min(sk, max(0, i + sk - sq + 1)) for i in range(sq)) if causal else sq * sk)
    elem = 2 if "bfloat16" in dtype or "float16" in dtype else 4
    t_ops = 4.0 * b * h * d * pairs / PEAK_BF16
    t_mem = elem * b * h * d * (2 * sq + 2 * sk) / HBM_BYTES_PER_S
    return max(t_ops, t_mem)


def k3_bound_s(q_shape) -> float:
    """Least time of one K3 call: 4·B·H·N²·D operations, or q, k, v, o
    (bf16) and the two float32 (B, H, N, g) biases moved once."""
    b, h, n, d = q_shape
    g = int(round(n ** 0.5))
    t_ops = 4.0 * b * h * n * n * d / PEAK_BF16
    t_mem = (2 * 4 * b * h * n * d + 4 * 2 * b * h * n * g) / HBM_BYTES_PER_S
    return max(t_ops, t_mem)
