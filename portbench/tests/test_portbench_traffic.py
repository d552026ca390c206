"""The generator's schedules for a seed, as the mixes specify them."""
import numpy as np
import pytest
import torch

from portbench import traffic


def test_agent_turn_cycles_its_lengths_from_any_seed():
    mix = traffic.load("agent_turn")
    assert mix["prompt_lengths"] == [6000 + t * (640 + 24) + 640 for t in range(4)]
    for seed in (0, 2**31 + 11):
        reqs = traffic.Requests(mix, 102400, seed, "cpu")
        batches = [reqs.next() for _ in range(9)]
        assert [b.prompts.shape for b in batches] == \
            [(4, mix["prompt_lengths"][i % 4]) for i in range(9)]
        assert all(b.new_tokens == 24 for b in batches)
        assert all(int(b.prompts.min()) >= 0 and int(b.prompts.max()) < 102400
                   for b in batches)
        warm = reqs.warmup()
        assert [w.prompts.shape[1] for w in warm] == mix["prompt_lengths"]
        assert all(w.new_tokens == mix["warmup_new_tokens"] for w in warm)


def test_rag_synth_batches():
    mix = traffic.load("rag_synth")
    b = traffic.Requests(mix, 102400, 7, "cpu").next()
    assert b.prompts.shape == (32, 1200) and b.new_tokens == 200


def test_the_same_seed_gives_the_same_requests():
    mix = traffic.load("agent_turn")
    a = traffic.Requests(mix, 1000, 5, "cpu")
    b = traffic.Requests(mix, 1000, 5, "cpu")
    c = traffic.Requests(mix, 1000, 6, "cpu")
    x, y, z = a.next(), b.next(), c.next()
    assert torch.equal(x.prompts, y.prompts) and not torch.equal(x.prompts, z.prompts)
    assert not torch.equal(a.warmup()[0].prompts, x.prompts[:, :mix["prompt_lengths"][0]])


@pytest.mark.parametrize("name", ["finetune.4x4096", "finetune.2x4096"])
def test_train_stream_is_the_programs(name):
    """The frozen copy of the synthetic stream gives the program's batches."""
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    mix = dict(traffic.load(name), seq_len=64)
    for seed, step in ((3, 0), (2**31 + 5, 7)):
        ours = traffic.train_batch(mix, 102400, seed, step)
        theirs = batch_for_step(DataConfig(vocab_size=102400, seq_len=64,
                                           global_batch=mix["batch"], seed=seed,
                                           structure=mix["structure"]),
                                step, device="cpu")
        for k in ("tokens", "labels"):
            assert ours[k].shape == (mix["batch"], 64)
            np.testing.assert_array_equal(ours[k], theirs[k].numpy())
    a = traffic.train_batch(mix, 102400, 3, 0)["tokens"]
    b = traffic.train_batch(mix, 102400, 3, 1)["tokens"]
    assert not np.array_equal(a, b)
