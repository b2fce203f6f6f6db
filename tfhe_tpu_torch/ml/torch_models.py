"""Torch test-model zoo: the pytest support library's model menagerie (a
copy of tfhe_tpu/ml/torch_models.py).

Analog of the reference's pytest model zoo (reference:
ml/concrete-ml/src/concrete/ml/pytest/torch_models.py -- FCSmall/FC :63,
CNN :127, CNNMaxPool :158, BranchingModule :436, BranchingGemmModule
:457, MultiInputNN :330, UnivariateModule :478, StepActivationModule
:503, NetWithConcatUnsqueeze :543, TorchSum :1063, WhereNet :1499,
AddNet :1520, ExpandModel :1541, PaddingNet :1194, ShapeOperationsNet
:1145, EmbeddingModel :1668, TinyCNN :679). Every model here exports
through ml/torch_export (torch.onnx.export with the stubbed onnx
module) and lowers through ml/onnx_frontend -- the sweep in
tests/test_torch_models.py is the conformance gate for the whole
torch -> ONNX -> quantized-DAG pipeline."""

from __future__ import annotations

import torch
import torch.nn as nn


class FCSmall(nn.Module):
    """Small fully-connected net (reference :63)."""

    def __init__(self, input_output: int = 5, activation=nn.ReLU):
        super().__init__()
        self.fc1 = nn.Linear(input_output, input_output * 2)
        self.act = activation()
        self.fc2 = nn.Linear(input_output * 2, input_output)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class FC(nn.Module):
    """Deeper MLP (reference :90)."""

    def __init__(self, input_output: int = 8, hidden: int = 32, activation=nn.ReLU):
        super().__init__()
        self.seq = nn.Sequential(
            nn.Linear(input_output, hidden), activation(),
            nn.Linear(hidden, hidden), activation(),
            nn.Linear(hidden, 4),
        )

    def forward(self, x):
        return self.seq(x)


class CNN(nn.Module):
    """Conv net with average pooling (reference :127)."""

    def __init__(self, in_ch: int = 1, activation=nn.ReLU):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, 4, 3)
        self.pool = nn.AvgPool2d(2, 2)
        self.act = activation()
        self.fc = nn.Linear(4 * 3 * 3, 3)

    def forward(self, x):
        x = self.pool(self.act(self.conv1(x)))
        return self.fc(torch.flatten(x, 1))


class CNNMaxPool(nn.Module):
    """Conv net with max pooling (reference :158)."""

    def __init__(self, in_ch: int = 1, activation=nn.ReLU):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, 4, 3)
        self.pool = nn.MaxPool2d(2, 2)
        self.act = activation()
        self.fc = nn.Linear(4 * 3 * 3, 3)

    def forward(self, x):
        x = self.pool(self.act(self.conv1(x)))
        return self.fc(torch.flatten(x, 1))


class TinyCNN(nn.Module):
    """Two-conv tiny CNN (reference :679)."""

    def __init__(self, n_classes: int = 2, activation=nn.ReLU):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 2, 3, stride=1, padding=0)
        self.conv2 = nn.Conv2d(2, 3, 3, stride=2, padding=0)
        self.act = activation()
        self.fc = nn.Linear(3 * 3 * 3, n_classes)

    def forward(self, x):
        x = self.act(self.conv1(x))
        x = self.act(self.conv2(x))
        return self.fc(torch.flatten(x, 1))


class BranchingModule(nn.Module):
    """Elementwise branches re-joined by adds (reference :436)."""

    def __init__(self, activation=nn.Sigmoid):
        super().__init__()
        self.act = activation()

    def forward(self, x):
        return x + self.act(x + 1.0) - self.act(x * 2.0)


class BranchingGemmModule(nn.Module):
    """Branches around a Gemm (reference :457)."""

    def __init__(self, input_output: int = 6, activation=nn.Sigmoid):
        super().__init__()
        self.act = activation()
        self.fc1 = nn.Linear(input_output, input_output)

    def forward(self, x):
        return x + self.act(x + 1.0) - self.act(self.fc1(x * 2.0))


class MultiInputNN(nn.Module):
    """Two graph inputs merged by add (reference :330)."""

    def __init__(self, input_output: int = 5, activation=nn.ReLU):
        super().__init__()
        self.act = activation()
        self.fc1 = nn.Linear(input_output, input_output)

    def forward(self, x, y):
        return self.fc1(self.act(x + y))


class UnivariateModule(nn.Module):
    """Chain of univariate (TLU-fusable) functions (reference :478)."""

    def forward(self, x):
        x = x.abs()
        x = torch.sigmoid(x)
        return torch.exp(-x) + 0.5 * torch.tanh(x)


class StepActivationModule(nn.Module):
    """Discontinuous step functions -> exact TLUs (reference :503)."""

    def forward(self, x):
        return torch.sign(x) + (x > 0.5).float() - (x < -0.5).float()


class NetWithConcatUnsqueeze(nn.Module):
    """Per-branch Gemms concatenated over a new axis (reference :543)."""

    def __init__(self, input_output: int = 5, n_fc_layers: int = 3):
        super().__init__()
        self.fcs = nn.ModuleList(
            [nn.Linear(input_output, 3) for _ in range(n_fc_layers)]
        )

    def forward(self, x):
        results = [fc(x).unsqueeze(1) for fc in self.fcs]
        return torch.cat(results, dim=1)


class TorchSum(nn.Module):
    """ReduceSum over an axis (reference :1063)."""

    def __init__(self, dim=1, keepdim=True):
        super().__init__()
        self.dim = dim
        self.keepdim = keepdim

    def forward(self, x):
        return x.sum(dim=self.dim, keepdim=self.keepdim)


class WhereNet(nn.Module):
    """Where with broadcast condition (reference :1499)."""

    def forward(self, x):
        return torch.where(x > 0.0, x * 2.0, -x)


class AddNet(nn.Module):
    """Pure scalar-add net (reference :1520)."""

    def forward(self, x):
        return x + 1.5


class ExpandModel(nn.Module):
    """Expand + mul (reference :1541)."""

    def forward(self, x):
        return (x.unsqueeze(-1).expand(-1, -1, 3) * 0.5).sum(dim=-1)


class PaddingNet(nn.Module):
    """Constant pad then linear (reference :1194)."""

    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(10, 2)

    def forward(self, x):
        x = torch.nn.functional.pad(x, (1, 1))
        return self.fc(x)


class ShapeOperationsNet(nn.Module):
    """Reshape/transpose/flatten chain (reference :1145)."""

    def forward(self, x):
        # -1 leads so the traced Reshape constants stay batch-agnostic
        # (torchscript export bakes literal x.shape[0] reads)
        y = x.reshape(-1, 2, 4)
        y = y.transpose(1, 2)
        return y.reshape(-1, 8) * 0.5


class EmbeddingModel(nn.Module):
    """Embedding lookup = Gather (reference :1668)."""

    def __init__(self, num_embeddings: int = 8, dim: int = 4):
        super().__init__()
        self.emb = nn.Embedding(num_embeddings, dim)

    def forward(self, idx):
        return self.emb(idx).sum(dim=1)


class MultiOpOnSingleInputConvNN(nn.Module):
    """Two convs over the same input, joined (reference :574)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 2, 3)
        self.conv2 = nn.Conv2d(1, 2, 3)

    def forward(self, x):
        a = torch.relu(self.conv1(x))
        b = torch.sigmoid(self.conv2(x))
        return torch.flatten(a + b, 1)
