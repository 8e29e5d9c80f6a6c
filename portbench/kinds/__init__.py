"""Configuration kinds: `<kind>.py` beside this file, named by a
configuration file's "kind" key ("edit" where it has none) and loaded by
`run.py`. A kind holds everything of a configuration that the harness
does not share:

- `cfgs(cfg_json)`: the reference's configuration dataclasses (`run.cfgs`);
- `traffic(run)`: an object whose `request(i)` draws request `i` from
  `run.seed`;
- `build(run)`: draws the weights from `run.seed` (`weights.draw` with the
  kind's module table), builds the program from them and sets `run.pipe`;
- `unit_flops(run, unit)`: the model FLOPs of one answered unit;
- `single_call(run, req, steps, refinement)`: one request through the
  program (the `single` driver's unit), its answer as a dict;
- `sample_key(req)`: the sample's first request has the largest key;
- `trail(outs)`: one answer as the kind's reference reads it;
- `readings(run, chosen)`: the reference's models, built after the program
  is freed, and the worst value of each number compared over the chosen
  (request, trail) pairs.

`correct.check` judges the readings against the cell's limits; no kind
replaces it.
"""
