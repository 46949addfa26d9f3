"""Pretrained feature extractors (counterpart of ``mtd_gan_tpu/features``):
VGG19 / VGG16 trunks, the ResNet50 trunk and the FID InceptionV3, with
torchvision's parameter names; weights from the standard torchvision files
where present, a seeded fallback otherwise (``registry``)."""

from mtd_gan_tpu_torch.features.registry import (
    feature_weights_status,
    get_extractor,
    get_inception_feature_fn,
    get_perceptual_fn,
    get_resnet_feature_fn,
    get_vgg_slices_fn,
)

__all__ = [
    "get_extractor",
    "get_vgg_slices_fn",
    "get_resnet_feature_fn",
    "get_inception_feature_fn",
    "get_perceptual_fn",
    "feature_weights_status",
]
