from ddl25spring_tpu_torch.fl.generative import TabularVAE, train_evaluator, tstr
from ddl25spring_tpu_torch.fl.horizontal import (
    CentralizedServer,
    FedAvgServer,
    FedSgdGradientServer,
)
from ddl25spring_tpu_torch.fl.vertical import VFLNetwork

__all__ = [
    "CentralizedServer",
    "FedAvgServer",
    "FedSgdGradientServer",
    "VFLNetwork",
    "TabularVAE",
    "train_evaluator",
    "tstr",
]
