"""Learning-rate schedules as epoch -> factor functions (counterpart of
gandtr_tpu/learning/schedules.py; the reference's base_schedulers.py). The
factor multiplies each parameter group's base learning rate
(optimizers.set_learning_rate). Ported so far: const and the fine-tune's
gamma; the GAN schedules (lambda, lambda_p2p) come with GAN training."""
import math


def const_schedule(**_):
    return lambda epoch: 1.0


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
}


def initialize_schedule(nepochs, params):
    params = dict(params)
    algorithm = params.pop("algorithm")
    return SCHEDULES[algorithm](nepochs, **params)
