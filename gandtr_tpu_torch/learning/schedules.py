"""Learning-rate schedules as epoch -> factor functions (counterpart of
gandtr_tpu/learning/schedules.py; the reference's base_schedulers.py). The
factor multiplies each parameter group's base learning rate
(optimizers.set_learning_rate). Each takes the zero-based epoch, as the
training loop calls it for its 1-based epoch e with e - 1. Ported: const,
the fine-tune's gamma and the GANs' lambda and lambda_p2p."""
import math


def const_schedule(**_):
    return lambda epoch: 1.0


def lambda_schedule(nepochs, fixed_ratio):
    """Fixed, then a linear decay towards zero (base_schedulers.py:15-20)."""
    def factor(epoch):
        return 1 - max(0, epoch + 1 - fixed_ratio * nepochs) \
            / float((1 - fixed_ratio) * nepochs + 1)
    return factor


def lambda_p2p_schedule(nepochs, n_epochs_decay):
    """CycleGAN's schedule (base_schedulers.py:28-45): the rate held for
    nepochs - n_epochs_decay epochs, then decayed linearly."""
    n_epochs = nepochs - n_epochs_decay

    def factor(epoch):
        return 1.0 - max(0, epoch + 1 - n_epochs) / float(n_epochs_decay + 1)
    return factor


def gamma_schedule(nepochs, gamma):
    """Exponential decay gamma**epoch for 0-indexed epochs (torch
    ExponentialLR holds the base rate through the first epoch); accepts
    "exp(x)" strings (base_schedulers.py:21-26)."""
    if isinstance(gamma, str) and gamma.startswith("exp(") \
            and gamma.endswith(")"):
        gamma = math.exp(float(gamma[4:-1]))
    return lambda epoch: float(gamma) ** epoch


SCHEDULES = {
    "const": lambda nepochs, **kw: const_schedule(),
    "gamma": lambda nepochs, **kw: gamma_schedule(nepochs, kw["gamma"]),
    "lambda": lambda nepochs, **kw: lambda_schedule(nepochs,
                                                    kw["fixed_ratio"]),
    "lambda_p2p": lambda nepochs, **kw: lambda_p2p_schedule(
        nepochs, kw["n_epochs_decay"]),
}


def initialize_schedule(nepochs, params):
    params = dict(params)
    algorithm = params.pop("algorithm")
    return SCHEDULES[algorithm](nepochs, **params)
