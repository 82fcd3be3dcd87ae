"""Small shared utilities of the port (counterpart of lvv_tpu/utils): the
stdout tee, the running average, host-0 logging, seeding and the native
TensorBoard scalar writer."""
from .logging import AverageMeter, Tee, is_host_zero, log0, seed_all
from .tb_writer import SummaryWriter

__all__ = ["AverageMeter", "Tee", "is_host_zero", "log0", "seed_all",
           "SummaryWriter"]
