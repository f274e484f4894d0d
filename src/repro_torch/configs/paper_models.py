"""The paper's evaluation models (port of ``repro.configs.paper_models``):
ResNet18/34, VGG11 and SqueezeNet (Tables 1-2, Fig. 6) and the ViT-12 of
Fig. 5, 12 encoders divided into 3 blocks of 4 for progressive training."""
from repro_torch.models.cnn import CNNConfig
from repro_torch.models.config import ModelConfig


def resnet18(num_classes: int = 10, image_size: int = 32,
             width_mult: float = 1.0) -> CNNConfig:
    return CNNConfig(name="resnet18", arch="resnet18",
                     num_classes=num_classes, image_size=image_size,
                     width_mult=width_mult)


def resnet34(num_classes: int = 10, image_size: int = 32,
             width_mult: float = 1.0) -> CNNConfig:
    return CNNConfig(name="resnet34", arch="resnet34",
                     num_classes=num_classes, image_size=image_size,
                     width_mult=width_mult)


def vgg11(num_classes: int = 10, image_size: int = 32,
          width_mult: float = 1.0) -> CNNConfig:
    return CNNConfig(name="vgg11", arch="vgg11", num_classes=num_classes,
                     image_size=image_size, width_mult=width_mult)


def squeezenet(num_classes: int = 10, image_size: int = 32,
               width_mult: float = 1.0) -> CNNConfig:
    return CNNConfig(name="squeezenet", arch="squeezenet",
                     num_classes=num_classes, image_size=image_size,
                     width_mult=width_mult)


def vit(num_classes: int = 100, image_size: int = 64,
        num_layers: int = 12, d_model: int = 384) -> ModelConfig:
    """ViT-12 for Mini-ImageNet (paper: 3 blocks x 4 encoders)."""
    return ModelConfig(
        name="vit12",
        family="dense",
        num_layers=num_layers,
        d_model=d_model,
        num_heads=6,
        num_kv_heads=6,
        d_ff=d_model * 4,
        vocab_size=num_classes,
        modality="image",
        task="classify",
        causal=False,
        act="gelu",
        image_size=image_size,
        patch_size=8,
        dtype="float32",
    )
