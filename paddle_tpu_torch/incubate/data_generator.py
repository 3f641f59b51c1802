"""MultiSlot data generators.

Copy of `paddle_tpu/incubate/data_generator.py` (it imports no JAX).

Reference: python/paddle/fluid/incubate/data_generator/__init__.py —
users subclass DataGenerator, implement generate_sample() yielding
[(slot_name, [values]), ...]; run_from_stdin()/run() emit the MultiSlot
text protocol that Dataset/DataFeed parses (each slot: count then
values), the format the reference's MultiSlot DataFeed reads.
"""

from __future__ import annotations

import sys
from typing import Callable, Iterable, List, Optional, Tuple

__all__ = ["DataGenerator", "MultiSlotDataGenerator"]


class DataGenerator:
    # -- user hooks ----------------------------------------------------------
    def generate_sample(self, line: Optional[str]):
        """Return a generator yielding one parsed sample per call:
        [(slot_name, [v0, v1, ...]), ...]. `line` is None in local_iter
        mode (self-generating) or a raw input line in stdin mode."""
        raise NotImplementedError

    def generate_batch(self, samples):
        """Optional batch-level hook (reference allows batch shuffling /
        negative sampling); default passes samples through."""
        for s in samples:
            yield s

    # -- emission ------------------------------------------------------------
    @staticmethod
    def _format(sample: List[Tuple[str, List]]) -> str:
        parts = []
        for _slot, values in sample:
            parts.append(str(len(values)))
            parts.extend(str(v) for v in values)
        return " ".join(parts)

    def _emit(self, samples, out):
        # generate_batch applies in EVERY mode — a batch-level override
        # (shuffling, negative sampling) must not silently vanish in the
        # production pipe path
        for sample in self.generate_batch(samples):
            out.write(self._format(sample) + "\n")

    def run_from_stdin(self, out=sys.stdout):
        """Pipe mode (the reference's pipe_command integration): parse
        stdin lines, emit MultiSlot lines."""
        def gen():
            for line in sys.stdin:
                yield from self.generate_sample(line.rstrip("\n"))()
        self._emit(gen(), out)

    def run_from_memory(self, out=sys.stdout):
        """Self-generating mode: generate_sample(None) produces samples."""
        self._emit(self.generate_sample(None)(), out)

    def write_to_file(self, path: str, mode: str = "memory",
                      lines: Optional[Iterable[str]] = None):
        """Convenience: emit a dataset part file (tests / local runs)."""
        with open(path, "w") as f:
            if mode == "memory":
                self.run_from_memory(out=f)
            else:
                def gen():
                    for line in lines or ():
                        yield from self.generate_sample(line)()
                self._emit(gen(), f)
        return path


class MultiSlotDataGenerator(DataGenerator):
    """reference MultiSlotDataGenerator: identical protocol; the subclass
    exists for API parity (slot declaration happens via
    dataset.set_use_var order)."""
    pass


class MultiSlotStringDataGenerator(DataGenerator):
    """reference: incubate/data_generator MultiSlotStringDataGenerator —
    slot values stay strings (no float/int conversion), the fastest path
    for string-keyed sparse features."""

    def _gen_str(self, line):
        if not isinstance(line, list) and not isinstance(line, tuple):
            raise ValueError(
                "the output of process() must be in list or tuple type")
        output = ""
        for index, item in enumerate(line):
            name, elements = item
            if output:
                output += " "
            out_str = [str(len(elements))]
            out_str.extend(str(x) for x in elements)
            output += " ".join(out_str)
        return output + "\n"


class SyntheticData(DataGenerator):
    """reference: incubate/data_generator/test_data_generator.py — fixed
    synthetic numeric slots for pipeline smoke tests."""

    def generate_sample(self, line):
        def data_iter():
            for _ in range(10000):
                yield ("words", [1, 2, 3, 4]), ("label", [0])
        return data_iter


class SyntheticStringData(DataGenerator):
    """String twin of SyntheticData."""

    def generate_sample(self, line):
        def data_iter():
            for _ in range(10000):
                yield ("words", ["a", "b", "c", "d"]), ("label", ["0"])
        return data_iter
