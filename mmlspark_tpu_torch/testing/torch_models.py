"""Plain-torch twins of published architectures: the port's copy of
``mmlspark_tpu/testing/torch_models.py``.

``TorchResNet18`` restates torchvision.models.resnet18 with the same
submodule names, so its ``state_dict()`` carries exactly the published
checkpoint's keys and shapes: the stand-in for a real download on a
machine without network (``importers.torch_import`` reads it through the
same path as a genuine torchvision file)."""

from __future__ import annotations


def build_torch_resnet18(num_classes: int = 1000):
    import torch.nn as nn

    class BasicBlock(nn.Module):
        def __init__(self, cin, cout, stride=1):
            super().__init__()
            self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(cout)
            self.relu = nn.ReLU(inplace=True)
            self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
            self.bn2 = nn.BatchNorm2d(cout)
            self.downsample = None
            if stride != 1 or cin != cout:
                self.downsample = nn.Sequential(
                    nn.Conv2d(cin, cout, 1, stride, bias=False),
                    nn.BatchNorm2d(cout))

        def forward(self, x):
            identity = x if self.downsample is None else self.downsample(x)
            out = self.relu(self.bn1(self.conv1(x)))
            out = self.bn2(self.conv2(out))
            return self.relu(out + identity)

    class TorchResNet18(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
            self.bn1 = nn.BatchNorm2d(64)
            self.relu = nn.ReLU(inplace=True)
            self.maxpool = nn.MaxPool2d(3, 2, 1)
            cin = 64
            for s, blocks in enumerate([2, 2, 2, 2]):
                cout = 64 * (2 ** s)
                layers = [BasicBlock(
                    cin if b == 0 else cout, cout,
                    stride=2 if (b == 0 and s > 0) else 1)
                    for b in range(blocks)]
                setattr(self, f"layer{s + 1}", nn.Sequential(*layers))
                cin = cout
            self.avgpool = nn.AdaptiveAvgPool2d(1)
            self.fc = nn.Linear(512, num_classes)

        def forward(self, x):
            x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
            for s in range(4):
                x = getattr(self, f"layer{s + 1}")(x)
            x = self.avgpool(x).flatten(1)
            return self.fc(x)

    return TorchResNet18()
