"""The tiny sizes of the cells added after the tests' table
(benchmark/tests/conftest.py `TINY`): each is added to that table when
pytest loads it, so the tests that run every cell of the manifest at a
CPU size find it too."""

TOWER = dict(num_hidden_layers=3, hidden_size=64, vocab_size=1000,
             num_attention_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
             qk_rope_head_dim=8, v_head_dim=16, intermediate_size=96,
             n_routed_experts=8, num_experts_per_tok=2,
             moe_intermediate_size=32, n_shared_experts=1)

TINY = {
    "moonlight_trans.eval": {
        "model": {"dim": 12, "n_heads": 2, "l_len": 6, "v_len": 9,
                  "a_len": 10, "l_dim": 64},
        "train": {"batch_size": 4},
        "traffic": {"n_pairs": 10, "check_pairs": 4, "tower": TOWER,
                    "transcript_tokens": [40, 0.5, 16, 96],
                    "sentence_tokens": [6, 0.4, 2, 12]}},
}


def pytest_plugin_registered(plugin, manager):
    table = getattr(plugin, "TINY", None)
    if isinstance(table, dict) and table is not TINY:
        for cell, sizes in TINY.items():
            table.setdefault(cell, sizes)
