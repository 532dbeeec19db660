"""Model FLOPs of the flagship PoSFeat (ResUNet encoder and decoder, the
KeypointDet head) from shapes, on the published dataflow: 2 × the MACs of
every convolution, the head at full resolution (upsample, concat, conv2).
The count is the same whatever implements it. Pooling, norms,
activations, the detector and the sampler are left out (a few percent of
the MACs at most)."""

# torchvision's bottleneck families, layers 1-3 only: (blocks, planes)
ENCODERS = {
    "resnet50": ((3, 64), (4, 128), (6, 256)),
    "resnet101": ((3, 64), (4, 128), (23, 256)),
    "resnet152": ((3, 64), (8, 128), (36, 256)),
}


def conv_flops(h_out: int, w_out: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * h_out * w_out * cin * cout * k * k


def backbone_flops(H: int, W: int, encoder: str, coarse_out: int, fine_out: int) -> float:
    """One image through the encoder (stem, layers 1-3) and the decoder."""
    h, w = H // 2, W // 2
    total = conv_flops(h, w, 3, 64, 7)
    h, w = -(-h // 2), -(-w // 2)  # the stem's max pool
    cin = 64
    for li, (blocks, planes) in enumerate(ENCODERS[encoder]):
        for bi in range(blocks):
            stride = 2 if (bi == 0 and li > 0) else 1
            ho, wo = -(-h // stride), -(-w // stride)
            total += conv_flops(h, w, cin, planes, 1)
            total += conv_flops(ho, wo, planes, planes, 3)
            total += conv_flops(ho, wo, planes, 4 * planes, 1)
            if bi == 0:
                total += conv_flops(ho, wo, cin, 4 * planes, 1)
            cin, h, w = 4 * planes, ho, wo
        if li == 0:
            c1, h1, w1 = cin, h, w
        elif li == 1:
            c2, h2, w2 = cin, h, w
    c3, h3, w3 = cin, h, w
    total += conv_flops(h3, w3, c3, coarse_out, 1)
    total += conv_flops(h2, w2, c3, 512, 3)  # upconv3
    total += conv_flops(h2, w2, c2 + 512, 512, 3)  # iconv3
    total += conv_flops(h1, w1, 512, 256, 3)  # upconv2
    total += conv_flops(h1, w1, c1 + 256, 256, 3)  # iconv2
    total += conv_flops(h1, w1, 256, fine_out, 1)  # conv_fine
    return total


def head_convs(H: int, W: int, in_channels: int) -> dict:
    """The head's convolutions on one image: {name: (flops, trainable input)}."""
    h, w = H // 4, W // 4
    return {
        "conv1": conv_flops(h, w, in_channels, in_channels, 3),
        "convimg": conv_flops(H, W, 3, 64, 3),
        "conv2": conv_flops(H, W, in_channels + 64, 128, 3),
        "conv3": conv_flops(H, W, 128, 1, 1),
    }


def extract_flops(H: int, W: int, model_config: dict) -> float:
    """The forward of one image: backbone and head."""
    bb = model_config["backbone_config"]
    head = head_convs(H, W, model_config["localheader_config"]["in_channels"])
    return backbone_flops(H, W, bb["encoder"], bb["coarse_out_ch"], bb["fine_out_ch"]) + sum(head.values())


def train_kp_flops(H: int, W: int, model_config: dict, pairs: int, m: int, n: int, D: int) -> float:
    """One stage-2 step of ``pairs`` image pairs: the frozen backbone's
    forward and the head's forward on both images, the head's weight
    gradients, the input gradients the chain needs (conv2 and conv3; the
    head's input is detached and the image needs none), and the
    reduction's m×n descriptor product and two epipolar products a pair."""
    bb = model_config["backbone_config"]
    head = head_convs(H, W, model_config["localheader_config"]["in_channels"])
    per_image = (backbone_flops(H, W, bb["encoder"], bb["coarse_out_ch"], bb["fine_out_ch"])
                 + 2 * sum(head.values()) + head["conv2"] + head["conv3"])
    return 2 * pairs * per_image + pairs * (2.0 * m * n * D + 2 * 2.0 * m * n * 3)
