"""Error types of the port, the counterparts of ``spartan_tpu/utils/errors.py``
(the reference's InvalidArgument / SumCheckError / WrongWitness /
SerializationError, src/error.rs:5-39)."""


class SpartanError(Exception):
    """Base error of spartan_tpu_torch."""


class InvalidArgument(SpartanError):
    """Bad argument (reference: src/error.rs InvalidArgument)."""


class SumCheckError(SpartanError):
    """Sumcheck round rejected (reference: src/error.rs SumCheckError)."""


class WrongWitness(SpartanError):
    """Witness fails verification (reference: src/error.rs WrongWitness)."""


class SerializationError(SpartanError):
    """Canonical (de)serialization failure (reference: src/error.rs)."""


def invalid_arg(msg: str) -> InvalidArgument:
    return InvalidArgument(msg)
