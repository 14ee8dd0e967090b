"""Mode domain model.

TPU-native mapping of the reference's CC / PPCIe mode semantics
(reference main.py:144-158, scripts/cc-manager.sh:111-123):

- CC modes: ``on`` / ``off`` / ``devtools`` — the TPU
  attestation/confidential-compute state of every chip on the node.
  ``devtools`` is the debuggable-attestation analog of the reference's
  devtools mode.
- ``ici`` — protected-ICI mode, the TPU analog of the reference's PPCIe
  ("protected PCIe") mode (reference main.py:154,456-484): link-level
  protection across the ICI fabric of a slice, covering chips *and* ICI
  switches (the NVSwitch analog, reference main.py:185).

Invariants (reference main.py:512-583):
- CC and ICI are mutually exclusive; enabling one first disables the other.
- ``off`` disables both.
"""

from __future__ import annotations

import enum


class Mode(str, enum.Enum):
    """Desired node security mode (value of the cc.mode label)."""

    ON = "on"
    OFF = "off"
    DEVTOOLS = "devtools"
    ICI = "ici"

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.value


#: Modes that are applied through the CC (attestation) state machine.
CC_MODES = (Mode.ON, Mode.OFF, Mode.DEVTOOLS)

#: All valid values for the desired-state label.
VALID_MODES = tuple(m.value for m in Mode)

#: Observed-state label value on any failure (reference
#: gpu_operator_eviction.py:279-286, main.py:300-307).
STATE_FAILED = "failed"


class InvalidModeError(ValueError):
    """Desired mode is not one of VALID_MODES (reference main.py:144-158)."""

    def __init__(self, mode: str):
        super().__init__(
            f"invalid CC mode {mode!r}: must be one of {', '.join(VALID_MODES)}"
        )
        self.mode = mode


def parse_mode(raw: str) -> Mode:
    """Validate and parse a raw label value into a Mode.

    The reference validates in ``CCManager.validate_cc_mode``
    (main.py:144-158) and the bash engine in ``_parse_mode``
    (scripts/cc-manager.sh:125-134); both reject unknown values loudly
    rather than defaulting.
    """
    try:
        return Mode(raw)
    except ValueError:
        raise InvalidModeError(raw) from None
