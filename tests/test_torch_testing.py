"""The port's ``testing.FakeModel`` (a scripted copy) against the JAX
package's: the JAX module's own scenarios, re-pointed at the port
(:mod:`torch_ported`), and the same outputs from both modules."""

import numpy as np
import pytest

from sonata_tpu.testing import FakeModel as JaxFake
from sonata_tpu_torch.testing import FakeModel
from torch_ported import exec_ported

exec_ported("test_fake_model.py", globals())


@pytest.mark.parametrize("phonemes", ["tɛst.", "abcdefgh", "wʌn tuː θɹiː."])
def test_fake_outputs_equal_the_reference(phonemes):
    for kw in ({}, {"sample_rate": 22050, "samples_per_phoneme": 256}):
        want, got = JaxFake(**kw), FakeModel(**kw)
        a = want.speak_one_sentence(phonemes)
        b = got.speak_one_sentence(phonemes)
        np.testing.assert_array_equal(b.samples.data, a.samples.data)
        assert b.inference_ms == a.inference_ms
        ca = [c.samples.data for c in want.stream_synthesis(phonemes, 3, 1)]
        cb = [c.samples.data for c in got.stream_synthesis(phonemes, 3, 1)]
        assert len(ca) == len(cb)
        for x, y in zip(ca, cb):
            np.testing.assert_array_equal(y, x)
