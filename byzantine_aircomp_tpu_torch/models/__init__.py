from .cnn import CNN, make_cnn  # noqa: F401
from .mlp import MLP, make_mlp  # noqa: F401
from .resnet import ResNet18, make_resnet18  # noqa: F401
