"""'sourmash signature' (sig) subcommands: signature manipulation utilities
(the port's copy of `sourmash_tpu/sig/__main__.py`; `kmers` sketches long
records through the port's MinHash, so on the card through K1/K2 and K3).

The 22 subcommands share one loading pipeline (`_SigStream`: moltype/
picklist/pattern selection, ``--from-file`` expansion, progress tracking) and
a handful of result-emission helpers; each command function is then a short
function over those stages, grouped below as

* whole-collection IO         — cat, split
* inspection                  — describe, fileinfo/summarize, manifest, overlap
* sketch set algebra          — merge, intersect, subtract, inflate
* per-sketch transforms       — rename, extract, filter, flatten, downsample
* interchange with mash       — ingest, export
* hash → sequence mapping     — kmers
* manifest/collection mgmt    — check, collect, grep

Behavior parity: reference `src/sourmash/sig/__main__.py` (cat:114, split:166,
describe:250, manifest:347, overlap:379, merge:459, intersect:526,
inflate:595, subtract:643, rename:715, extract:753, filter:830, flatten:881,
downsample:926, ingest:1002, export:1059, kmers:1087, fileinfo:1343,
check:1412, collect:1553) and `sig/grep.py:14-139`. Console/CSV formats
match the reference exactly.
"""

from __future__ import annotations

import csv
import os
import sys
from collections import Counter, defaultdict, namedtuple

import sourmash_tpu_torch as sourmash
from .. import sourmash_args
from ..logging import set_quiet, error, notify, print_results, debug
from ..minhash import _get_max_hash_for_scaled, MinHash

_extend_notes = "(also see 'sourmash sig --help')"


# ---------------------------------------------------------------------------
# the shared loading pipeline + small helpers
# ---------------------------------------------------------------------------


def _extend_signatures_with_from_file(args, target_attr="signatures"):
    "Fold any --from-file pathlist into the positional location list."
    if getattr(args, "from_file", None):
        more = sourmash_args.load_pathlist_from_file(args.from_file)
        setattr(args, target_attr, list(getattr(args, target_attr)) + list(more))


class _SigStream:
    """Standard signature-loading pipeline for sig subcommands.

    Parses the moltype/picklist(/pattern) selectors once, expands
    ``--from-file``, and iterates (signature, location) pairs across every
    input with progress tracking. ``len()`` reports signatures loaded so far.
    """

    def __init__(self, args, *, use_pattern=False, expand_attr="signatures"):
        self.args = args
        self.moltype = sourmash_args.calculate_moltype(args)
        self.picklist = sourmash_args.load_picklist(args)
        self.pattern = None
        if use_pattern:
            self.pattern = sourmash_args.load_include_exclude_db_patterns(args)
        if expand_attr:
            _extend_signatures_with_from_file(args, expand_attr)
        self.progress = sourmash_args.SignatureLoadingProgress()

    def __iter__(self):
        yield from sourmash_args.load_many_signatures(
            self.args.signatures,
            ksize=self.args.ksize,
            moltype=self.moltype,
            picklist=self.picklist,
            progress=self.progress,
            yield_all_files=self.args.force,
            force=self.args.force,
            pattern=self.pattern,
        )

    def __len__(self):
        return len(self.progress)

    def report_picklist(self):
        if self.picklist:
            sourmash_args.report_picklist(self.args, self.picklist)


def _check_abundance_compatibility(sig1, sig2):
    if sig1.minhash.track_abundance != sig2.minhash.track_abundance:
        raise ValueError(
            "incompatible signatures: track_abundance is {} in first sig, {} in second".format(
                sig1.minhash.track_abundance, sig2.minhash.track_abundance
            )
        )



def _abort_no_picklist_support(cmd, *, kinds="picklists", kind="a picklist", pipe_to=None):
    "Consistent abort when an index type cannot subset by picklist."
    error(f"** This input collection doesn't support '{cmd}' with {kinds}.")
    error("** EXITING.")
    error("**")
    error(f"** You can use 'sourmash sig cat' with {kind},")
    error(f"** and then pipe the output to 'sourmash sig {pipe_to or cmd}")
    sys.exit(-1)


def _loaded_extracted_summary(n_loaded, n_saved, n_files):
    "The standard two-line summary used by the per-sketch transforms."
    notify(f"loaded {n_loaded} total that matched ksize & molecule type")
    notify(f"extracted {n_saved} signatures from {n_files} file(s)")


def _save_named_result(args, mh):
    "Wrap a result MinHash in a signature named --name and write it out."
    out = sourmash.SourmashSignature(mh, name=args.set_name or "")
    out._name = args.set_name
    with sourmash_args.SaveSignaturesToLocation(args.output) as save_sigs:
        save_sigs.add(out)


def _reinflate_from_file(mh, args, moltype):
    "Re-attach abundances to `mh` from the --abundances-from signature."
    notify(f"loading signature from {args.abundances_from}, keeping abundances")
    abund_sig = sourmash_args.load_one_signature(
        args.abundances_from, ksize=args.ksize, select_moltype=moltype
    )
    if not abund_sig.minhash.track_abundance:
        error("--track-abundance not set on loaded signature?! exiting.")
        sys.exit(-1)
    return mh.inflate(abund_sig.minhash)


# ---------------------------------------------------------------------------
# whole-collection IO: cat, split
# ---------------------------------------------------------------------------


def cat(args):
    "Concatenate all signatures into one file."
    set_quiet(args.quiet, args.debug)
    stream = _SigStream(args, use_pattern=True)

    seen_md5 = defaultdict(int)

    save_sigs = sourmash_args.SaveSignaturesToLocation(args.output)
    save_sigs.open()

    for ss, _ in stream:
        md5 = ss.md5sum()
        seen_md5[md5] += 1
        if args.unique and seen_md5[md5] > 1:
            continue
        save_sigs.add(ss)

    notify(f"loaded {len(save_sigs)} signatures total.")
    stream.report_picklist()

    save_sigs.close()

    notify(f"output {len(save_sigs)} signatures")

    n_dup_md5 = sum(1 for cnt in seen_md5.values() if cnt > 1)
    if n_dup_md5:
        notify(f"encountered {n_dup_md5} MinHashes multiple times")
        if args.unique:
            notify("...and removed the duplicates, because --unique was specified.")


# split output naming: one template per sketch kind, plus a dup counter
_SPLIT_TEMPLATES = {
    "scaled": "{md5sum}.k={ksize}.scaled={scaled}.{moltype}.dup={dup}.{basename}",
    "num": "{md5sum}.k={ksize}.num={num}.{moltype}.dup={dup}.{basename}",
}


def _unique_split_name(ss, taken, extension):
    "Derive a collision-free output filename for one signature in `split`."
    mh = ss.minhash
    basename = os.path.basename(ss.filename)
    if not basename or basename == "-":
        basename = "none"

    kind = "scaled" if mh.scaled else "num"
    if kind == "num":
        assert mh.num
    template = _SPLIT_TEMPLATES[kind] + extension

    fields = dict(
        basename=basename,
        md5sum=ss.md5sum()[:8],
        scaled=mh.scaled,
        ksize=mh.ksize,
        num=mh.num,
        moltype=mh.moltype,
    )

    n = 0
    while True:
        fields["dup"] = n
        name = template.format(**fields)
        if name not in taken:
            break
        n += 1
    taken.add(name)
    return name


def split(args):
    "Split all signatures into individual files."
    set_quiet(args.quiet)
    stream = _SigStream(args)

    if args.output_dir:
        if not os.path.exists(args.output_dir):
            notify(f"Creating --output-dir {args.output_dir}")
            os.mkdir(args.output_dir)

    taken = set()
    for ss, _ in stream:
        output_name = _unique_split_name(ss, taken, args.extension)

        if args.output_dir:
            output_name = os.path.join(args.output_dir, output_name)

        if os.path.exists(output_name):
            notify(f"** overwriting existing file {format(output_name)}")

        with sourmash_args.SaveSignaturesToLocation(output_name) as save_sigs:
            save_sigs.add(ss)
            notify(f"writing sig to {output_name}")

    notify(f"loaded and split {len(stream)} signatures total.")
    stream.report_picklist()


# ---------------------------------------------------------------------------
# inspection: describe, fileinfo/summarize, manifest, overlap
# ---------------------------------------------------------------------------

_DESCRIBE_FIELDS = [
    "signature_file",
    "md5",
    "ksize",
    "moltype",
    "num",
    "scaled",
    "n_hashes",
    "seed",
    "with_abundance",
    "name",
    "filename",
    "license",
    "sum_hashes",
]


def describe(args):
    "Provide basic info on signatures."
    set_quiet(args.quiet, args.debug)
    stream = _SigStream(args, use_pattern=True)

    w = None
    csv_obj = None
    if args.csv:
        csv_obj = sourmash_args.FileOutputCSV(args.csv)
        w = csv.DictWriter(csv_obj.open(), _DESCRIBE_FIELDS, extrasaction="ignore")
        w.writeheader()

    for ss, location in stream:
        mh = ss.minhash
        row = dict(
            signature_file=location,
            md5=ss.md5sum(),
            ksize=mh.ksize,
            moltype=mh.moltype,
            num=mh.num,
            scaled=mh.scaled,
            n_hashes=len(mh),
            seed=mh.seed,
            with_abundance=int(mh.track_abundance),
            name=ss.name,
            filename=ss.filename,
            license=ss.license,
            sum_hashes=sum(mh.hashes.values()),
        )

        if w:
            w.writerow(row)

        print_results(
            """\
---
signature filename: {signature_file}
signature: {p_name}
source file: {p_filename}
md5: {md5}
k={ksize} molecule={moltype} num={num} scaled={scaled} seed={seed} track_abundance={with_abundance}
size: {n_hashes}
sum hashes: {sum_hashes}
signature license: {license}
""",
            p_name=row["name"] or "** no name **",
            p_filename=row["filename"] or "** no name **",
            **row,
        )

    if csv_obj:
        csv_obj.close()

    stream.report_picklist()


_SketchInfo = namedtuple("_SketchInfo", "ksize, moltype, scaled, num, abund")


def _summarize_manifest(manifest):
    "Summary dict of sketch types in a manifest (reference :1283-1313)."
    kinds = Counter()
    kind_hashes = Counter()
    total_size = 0
    for row in manifest.rows:
        ski = _SketchInfo(
            ksize=row["ksize"],
            moltype=row["moltype"],
            scaled=row["scaled"],
            num=row["num"],
            abund=row["with_abundance"],
        )
        kinds[ski] += 1
        kind_hashes[ski] += row["n_hashes"]
        total_size += row["n_hashes"]

    return dict(
        total_hashes=total_size,
        sketch_info=[
            dict(ski._asdict(), count=count, n_hashes=kind_hashes[ski])
            for ski, count in kinds.items()
        ],
    )


def _die(*messages, code=-1):
    "Print error line(s) and exit."
    for msg in messages:
        error(msg)
    sys.exit(code)


def _manifest_required_abort(first_line, cmd):
    "Exact console shape for a missing-manifest abort, then exit."
    error(first_line)
    error(f"sig {cmd} requires a manifest by default, but no manifest present.")
    error("specify --no-require-manifest to dynamically generate one.")
    sys.exit(-1)


def _relpath_to_output(target):
    "Relative path from the output manifest's directory back to cwd."
    return os.path.relpath(os.curdir, os.path.dirname(target))


def fileinfo(args):
    """Summary information on a signature collection/index (reference
    `sig/__main__.py:1343-1409`). Aliased as 'summarize'."""
    import json

    set_quiet(args.quiet, args.debug)

    text_out = not args.json_out

    try:
        notify(f"** loading from '{args.path}'")
        idx = sourmash_args.load_file_as_index(args.path, yield_all_files=args.force)
    except ValueError:
        error(f"Cannot open '{args.path}' as a sourmash signature collection.")
        error("Use -d/--debug for details.")
        sys.exit(-1)

    def print_bool(x):
        return "yes" if x else "no"

    info_d = dict(
        path_filetype=type(idx).__name__,
        location=idx.location or "",
        is_database=bool(idx.is_database),
        has_manifest=bool(idx.manifest),
        num_sketches=len(idx),
    )

    if text_out:
        for line in (
            f"path filetype: {info_d['path_filetype']}",
            f"location: {info_d['location']}",
            f"is database? {print_bool(info_d['is_database'])}",
            f"has manifest? {print_bool(info_d['has_manifest'])}",
            f"num signatures: {info_d['num_sketches']}",
        ):
            print_results(line)

    notify("** examining manifest...")

    manifest = sourmash_args.get_manifest(
        idx, rebuild=args.rebuild_manifest, require=False
    )

    if manifest is None:
        notify("** no manifest and cannot be generated; exiting.")
        sys.exit(0)

    info_d.update(_summarize_manifest(manifest))

    if not text_out:
        print(json.dumps(info_d))
        return

    print_results(f"total hashes: {info_d['total_hashes']}")
    print_results("summary of sketches:")
    for ski in info_d["sketch_info"]:
        mh_type = f"num={ski['num']}" if ski["num"] else f"scaled={ski['scaled']}"
        mh_abund = ", abund" if ski["abund"] else ""
        sketch_str = f"{ski['count']} sketches with {ski['moltype']}, k={ski['ksize']}, {mh_type}{mh_abund}"
        print_results(f"   {sketch_str: <50} {ski['n_hashes']} total hashes")


# alias, reference cli aliases 'summarize' to fileinfo
summarize = fileinfo


def manifest(args):
    "Build a signature manifest."
    set_quiet(args.quiet, args.debug)

    try:
        loader = sourmash_args.load_file_as_index(args.location,
                                                  yield_all_files=args.force)
    except ValueError:
        error(f"Cannot open '{args.location}' as a sourmash signature collection.")
        error("Use -d/--debug for details.")
        sys.exit(-1)

    rebuild = not args.no_rebuild_manifest
    debug("sig manifest: forcing rebuild." if rebuild
          else "sig manifest: not forcing rebuild.")

    mf = sourmash_args.get_manifest(loader, require=True, rebuild=rebuild)
    mf._check_row_values()

    mf.write_to_filename(
        args.output, database_format=args.manifest_format, ok_if_exists=args.force
    )
    notify(f"manifest contains {len(mf)} signatures total.")
    notify(f"wrote manifest to '{args.output}' ({args.manifest_format})")


def overlap(args):
    "Provide detailed comparison of two signatures."
    set_quiet(args.quiet)
    moltype = sourmash_args.calculate_moltype(args)

    def one_sig(path):
        return sourmash_args.load_one_signature(path, ksize=args.ksize,
                                                select_moltype=moltype)

    sig1, sig2 = one_sig(args.signature1), one_sig(args.signature2)
    notify(f"loaded one signature each from {args.signature1} and {args.signature2}")

    hashes_1 = set(sig1.minhash.hashes)
    hashes_2 = set(sig2.minhash.hashes)

    fields = dict(
        sig1_file=args.signature1,
        sig2_file=args.signature2,
        name1=sig1.name,
        name2=sig2.name,
        md5_1=sig1.md5sum(),
        md5_2=sig2.md5sum(),
        ksize=sig1.minhash.ksize,
        moltype=sig1.minhash.moltype,
        num=sig1.minhash.num,
        scaled=sig1.minhash.scaled,
        similarity=sig1.similarity(sig2),
        cont1=sig1.contained_by(sig2),
        cont2=sig2.contained_by(sig1),
        size1=len(sig1.minhash),
        size2=len(sig2.minhash),
        num_common=len(hashes_1 & hashes_2),
        disjoint_1=len(hashes_1 - hashes_2),
        disjoint_2=len(hashes_2 - hashes_1),
        num_union=len(hashes_1 | hashes_2),
    )

    report_lines = (
        "first signature:",
        "  signature filename: {sig1_file}",
        "  signature: {name1}",
        "  md5: {md5_1}",
        "  k={ksize} molecule={moltype} num={num} scaled={scaled}",
        "",
        "second signature:",
        "  signature filename: {sig2_file}",
        "  signature: {name2}",
        "  md5: {md5_2}",
        "  k={ksize} molecule={moltype} num={num} scaled={scaled}",
        "",
        "similarity:                  {similarity:.5f}",
        "first contained in second:   {cont1:.5f}",
        "second contained in first:   {cont2:.5f}",
        "",
        "number of hashes in first:   {size1}",
        "number of hashes in second:  {size2}",
        "",
        "number of hashes in common:  {num_common}",
        "only in first:               {disjoint_1}",
        "only in second:              {disjoint_2}",
        "total (union):               {num_union}",
        "",
    )
    print("\n".join(report_lines).format(**fields))


# ---------------------------------------------------------------------------
# sketch set algebra: merge, intersect, subtract, inflate
# ---------------------------------------------------------------------------


def merge(args):
    "Merge one or more signatures."
    set_quiet(args.quiet)
    stream = _SigStream(args)

    first_sig = None
    merged_mh = None

    for sigobj, sigloc in stream:
        if first_sig is None:
            first_sig = sigobj
            merged_mh = first_sig.minhash.copy_and_clear().to_mutable()
            if args.flatten:
                merged_mh.track_abundance = False

        try:
            incoming = sigobj.minhash
            if args.flatten:
                incoming = incoming.flatten()
            else:
                _check_abundance_compatibility(first_sig, sigobj)

            merged_mh.merge(incoming)
        except (TypeError, ValueError) as exc:
            error(
                "ERROR when merging signature '{}' ({}) from file {}",
                sigobj,
                sigobj.md5sum()[:8],
                sigloc,
            )
            error(str(exc))
            sys.exit(-1)

    if not len(stream):
        error("no signatures to merge!?")
        sys.exit(-1)

    _save_named_result(args, merged_mh)

    notify(f"loaded and merged {len(stream)} signatures")
    stream.report_picklist()


def intersect(args):
    "Intersect one or more signatures; removes abundances unless -A."
    set_quiet(args.quiet)
    stream = _SigStream(args)

    template_sig = None
    common = None

    for sigobj, _ in stream:
        if template_sig is None:
            template_sig = sigobj
            common = set(sigobj.minhash.hashes)
        elif not sigobj.minhash.is_compatible(template_sig.minhash):
            error("incompatible minhashes; specify -k and/or molecule type.")
            sys.exit(-1)

        common.intersection_update(sigobj.minhash.hashes)

    if template_sig is None:
        notify("no signatures provided to intersect!?")
        sys.exit(-1)

    intersect_mh = template_sig.minhash.copy_and_clear().flatten().to_mutable()
    intersect_mh.add_many(common)

    if args.abundances_from:
        intersect_mh = _reinflate_from_file(intersect_mh, args, stream.moltype)

    _save_named_result(args, intersect_mh)

    notify(f"loaded and intersected {len(stream)} signatures")
    stream.report_picklist()


def _refuse_abund_subtract(mh, flatten):
    "subtract only works on flat sketches unless --flatten was requested."
    if mh.track_abundance and not flatten:
        error("Cannot use subtract on signatures with abundance tracking, sorry!")
        sys.exit(1)


def subtract(args):
    "Subtract one or more signatures from another."
    set_quiet(args.quiet)
    moltype = sourmash_args.calculate_moltype(args)

    # --abundances-from implies flattening the subtraction operands
    if args.abundances_from:
        args.flatten = True

    from_sigobj = sourmash_args.load_one_signature(
        args.signature_from, ksize=args.ksize, select_moltype=moltype
    )
    from_mh = from_sigobj.minhash
    _refuse_abund_subtract(from_mh, args.flatten)

    remaining = set(from_mh.hashes)

    notify(f"loaded signature from {args.signature_from}...", end="\r")

    progress = sourmash_args.SignatureLoadingProgress()

    for sigfile in args.subtraction_sigs:
        subtrahends = sourmash_args.load_file_as_signatures(
            sigfile, ksize=args.ksize, select_moltype=moltype, progress=progress
        )
        for sigobj in subtrahends:
            if not sigobj.minhash.is_compatible(from_mh):
                error("incompatible minhashes; specify -k and/or molecule type.")
                sys.exit(-1)
            _refuse_abund_subtract(sigobj.minhash, args.flatten)

            remaining -= set(sigobj.minhash.hashes)
            notify(f"loaded and subtracted signatures from {sigfile}...", end="\r")

    if not len(progress):
        error("no signatures to subtract!?")
        sys.exit(-1)

    subtract_mh = from_sigobj.minhash.copy_and_clear().flatten().to_mutable()
    subtract_mh.add_many(remaining)

    if args.abundances_from:
        subtract_mh = _reinflate_from_file(subtract_mh, args, moltype)

    _save_named_result(args, subtract_mh)

    notify(f"loaded and subtracted {len(progress)} signatures")


def inflate(args):
    "Inflate (add abundances to) signatures from the first signature."
    set_quiet(args.quiet)
    moltype = sourmash_args.calculate_moltype(args)
    picklist = sourmash_args.load_picklist(args)

    inflate_sig = sourmash_args.load_query_signature(
        args.signature_from, ksize=args.ksize, select_moltype=moltype
    )
    inflate_from_mh = inflate_sig.minhash

    if not inflate_from_mh.track_abundance:
        error(f"ERROR: signature '{inflate_sig.name}' from ")
        error(f"file '{args.signature_from}' has no abundances.")
        sys.exit(-1)

    progress = sourmash_args.SignatureLoadingProgress()
    loader = sourmash_args.load_many_signatures(
        args.other_sigs,
        ksize=inflate_from_mh.ksize,
        moltype=inflate_from_mh.moltype,
        picklist=picklist,
        progress=progress,
        yield_all_files=args.force,
        force=args.force,
    )

    with sourmash_args.SaveSignaturesToLocation(args.output) as save_sigs:
        for sigobj, _ in loader:
            inflated_mh = sigobj.minhash.inflate(inflate_from_mh)
            save_sigs.add(sourmash.SourmashSignature(inflated_mh, name=sigobj.name))

        n_saved = len(save_sigs)

    if len(progress) == 0:
        error("no signatures to inflate!?")
        sys.exit(-1)

    notify(f"loaded and intersected {n_saved} signatures")
    if picklist:
        sourmash_args.report_picklist(args, picklist)


# ---------------------------------------------------------------------------
# per-sketch transforms: rename, extract, filter, flatten, downsample
# ---------------------------------------------------------------------------


def rename(args):
    "Rename one or more signatures."
    set_quiet(args.quiet, args.quiet)
    stream = _SigStream(args, use_pattern=True)

    save_sigs = sourmash_args.SaveSignaturesToLocation(args.output)
    save_sigs.open()

    for sigobj, _ in stream:
        renamed = sigobj.to_mutable()
        renamed._name = args.name
        save_sigs.add(renamed)

    save_sigs.close()

    notify(f"set name to '{args.name}' on {len(save_sigs)} signatures")
    stream.report_picklist()


def extract(args):
    "Extract signatures matching filters."
    set_quiet(args.quiet)
    moltype = sourmash_args.calculate_moltype(args)
    picklist = sourmash_args.load_picklist(args)
    pattern_search = sourmash_args.load_include_exclude_db_patterns(args)
    _extend_signatures_with_from_file(args)

    filter_fn = None
    if args.md5 is not None or args.name is not None:

        def filter_fn(row):
            if args.name and args.name in (row["name"] or row["filename"]):
                return True
            return bool(args.md5 and args.md5 in row["md5"])

    save_sigs = sourmash_args.SaveSignaturesToLocation(args.output)
    save_sigs.open()

    total_rows_examined = 0
    for filename in args.signatures:
        idx = sourmash_args.apply_picklist_and_pattern(
            sourmash_args.load_file_as_index(
                filename, yield_all_files=args.force
            ).select(ksize=args.ksize, moltype=moltype),
            picklist,
            pattern_search,
        )
        manifest = sourmash_args.get_manifest(idx)
        total_rows_examined += len(manifest)

        if filter_fn and not pattern_search:
            sub_picklist = manifest.filter_rows(filter_fn).to_picklist()

            try:
                idx = idx.select(picklist=sub_picklist)
            except ValueError:
                _abort_no_picklist_support(
                    "extract",
                    kinds="picklists or patterns",
                    kind="a picklist or pattern",
                )

        for ss in idx.signatures():
            save_sigs.add(ss)

    notify(f"loaded {total_rows_examined} total that matched ksize & molecule type")
    save_sigs.close()

    if save_sigs:
        notify(
            f"extracted {len(save_sigs)} signatures from {len(args.signatures)} file(s)"
        )
    else:
        _die("no matching signatures to save!")
    if picklist:
        sourmash_args.report_picklist(args, picklist)


def filter(args):
    "Filter hashes by abundance in all of the signatures."
    set_quiet(args.quiet)
    moltype = sourmash_args.calculate_moltype(args)

    progress = sourmash_args.SignatureLoadingProgress()

    save_sigs = sourmash_args.SaveSignaturesToLocation(args.output)
    save_sigs.open()

    for filename in args.signatures:
        siglist = list(
            sourmash_args.load_file_as_signatures(
                filename, ksize=args.ksize, select_moltype=moltype, progress=progress
            )
        )

        narrowers = (
            (args.md5, lambda ss: args.md5 in ss.md5sum()),
            (args.name, lambda ss: args.name in str(ss)),
        )
        for wanted, keep in narrowers:
            if wanted is not None:
                siglist = [ss for ss in siglist if keep(ss)]

        for ss in siglist:
            mh = ss.minhash
            if not mh.track_abundance:
                notify(f"ignoring signature {ss} - track_abundance not set.")
                continue

            kept = {
                hashval: abund
                for hashval, abund in mh.hashes.items()
                if abund >= args.min_abundance
                and (args.max_abundance is None or abund <= args.max_abundance)
            }

            filtered_mh = mh.copy_and_clear().to_mutable()
            filtered_mh.set_abundances(kept)

            ss = ss.to_mutable()
            ss.minhash = filtered_mh

            save_sigs.add(ss)

    save_sigs.close()

    _loaded_extracted_summary(len(progress), len(save_sigs), len(args.signatures))


def flatten(args):
    "Flatten one or more signatures, removing abundances."
    set_quiet(args.quiet)
    stream = _SigStream(args)

    save_sigs = sourmash_args.SaveSignaturesToLocation(args.output)
    save_sigs.open()

    for ss, _ in stream:
        if args.md5 is not None and args.md5 not in ss.md5sum():
            continue
        if args.name is not None and args.name not in ss.name:
            continue

        ss = ss.to_mutable()
        ss.minhash = ss.minhash.flatten()
        save_sigs.add(ss)

    save_sigs.close()

    _loaded_extracted_summary(len(stream), len(save_sigs), len(args.signatures))
    stream.report_picklist()


def _set_num_scaled(mh, num, scaled):
    "Set num and scaled values on a MinHash, re-inserting mins to re-trim."
    import numpy as np

    from ..minhash import _get_scaled_for_max_hash

    mins, abunds = mh._mins, mh._abunds
    mh._num = num
    mh._max_hash = _get_max_hash_for_scaled(scaled)
    mh._scaled_cache = _get_scaled_for_max_hash(mh._max_hash)
    mh._mins = np.zeros(0, dtype=np.uint64)
    if mh._track_abundance:
        mh._abunds = np.zeros(0, dtype=np.uint64)
    mh._invalidate()
    mh._insert_hashes(mins, abunds)
    assert mh.num == num
    assert mh.scaled == scaled


def _as_scaled(mh, scaled):
    "Downsample a scaled MinHash, or convert a num MinHash to scaled."
    if mh.scaled:
        return mh.downsample(scaled=scaled)

    max_hash = _get_max_hash_for_scaled(scaled)
    if max(mh.hashes) < max_hash:
        raise ValueError(
            "this num MinHash does not have enough hashes to convert it into a scaled MinHash."
        )
    converted = mh.copy().to_mutable()
    _set_num_scaled(converted, 0, scaled)
    return converted


def _as_num(mh, num):
    "Downsample a num MinHash, or convert a scaled MinHash to num."
    if mh.num:
        return mh.downsample(num=num)

    if len(mh) < num:
        raise ValueError(f"this scaled MinHash has only {len(mh)} hashes")
    converted = mh.copy().to_mutable()
    _set_num_scaled(converted, num, 0)
    return converted


def downsample(args):
    "Downsample num and scaled signatures; also interconvert."
    set_quiet(args.quiet)

    if not args.num_hashes and not args.scaled:
        error("ERROR: must specify either --num or --scaled value")
        sys.exit(-1)

    if args.num_hashes and args.scaled:
        error("ERROR: cannot specify both --num and --scaled")
        sys.exit(-1)

    stream = _SigStream(args)

    save_sigs = sourmash_args.SaveSignaturesToLocation(args.output)
    save_sigs.open()

    for ss, _ in stream:
        sigobj = ss.to_mutable()

        if args.scaled:
            sigobj.minhash = _as_scaled(sigobj.minhash, int(args.scaled))
        elif args.num_hashes:
            sigobj.minhash = _as_num(sigobj.minhash, args.num_hashes)

        save_sigs.add(sigobj)

    save_sigs.close()

    notify(f"loaded {len(stream)} signatures")
    notify(f"output {len(save_sigs)} downsampled signatures", len(save_sigs))
    stream.report_picklist()


# ---------------------------------------------------------------------------
# interchange with mash: ingest, export
# ---------------------------------------------------------------------------


def _sigs_from_mash_csv(filename):
    "Parse one mash CSV file into a list of signatures."
    out = []
    with open(filename, newline="") as csv_fp:
        for row in csv.reader(csv_fp):
            hashfn = row[0]
            hashseed = int(row[1])
            assert hashfn == "murmur64"
            assert hashseed == 42

            _, _, ksize, name, hashes = row
            hashes = [int(x) for x in hashes.strip().split(" ")]

            e = MinHash(len(hashes), int(ksize))
            e.add_many(hashes)
            s = sourmash.SourmashSignature(e, filename=name)
            out.append(s)
            notify(f"loaded signature: {name} {s.md5sum()[:8]}")
    return out


def _sig_from_mash_json(filename):
    "Parse one mash-style JSON sketch file into a signature."
    import json

    with open(filename) as fp:
        x = json.loads(fp.read())

    assert x["hashType"] == "MurmurHash3_x64_128"
    assert x["hashBits"] == 64
    assert x["hashSeed"] == 42

    mh = MinHash(ksize=x["kmer"], n=x["sketchSize"], is_protein=False)
    mh.add_many(x["sketches"][0]["hashes"])
    return sourmash.SourmashSignature(mh, filename=filename)


def ingest(args):
    """Import signatures from mash JSON or CSV into sourmash format
    (reference `sig/__main__.py:1002-1056`)."""
    set_quiet(args.quiet)

    siglist = []
    for filename in args.filenames:
        if args.csv:
            siglist = _sigs_from_mash_csv(filename)
        else:
            siglist.append(_sig_from_mash_json(filename))

    notify(f"saving {len(siglist)} signatures to JSON")
    with sourmash_args.SaveSignaturesToLocation(args.output) as save_sigs:
        save_sigs.add_many(siglist)


def export(args):
    """Export a signature to mash-style JSON (reference
    `sig/__main__.py:1059-1084`)."""
    import json

    set_quiet(args.quiet)
    moltype = sourmash_args.calculate_moltype(args)

    query = sourmash_args.load_query_signature(
        args.filename, ksize=args.ksize, select_moltype=moltype, select_md5=args.md5
    )
    mh = query.minhash

    doc = dict(
        kmer=mh.ksize,
        sketchSize=len(mh),
        hashType="MurmurHash3_x64_128",
        hashBits=64,
        hashSeed=mh.seed,
        sketches=[{"hashes": list(mh.hashes)}],
    )

    with sourmash_args.FileOutput(args.output, "wt") as fp:
        print(json.dumps(doc), file=fp)
    notify(f"exported signature {query} ({query.md5sum()[:8]})")


# ---------------------------------------------------------------------------
# hash → sequence mapping: kmers
# ---------------------------------------------------------------------------


def _merged_query_for_kmers(stream):
    "Merge every input sketch (abundances dropped) into one query MinHash."
    query_mh = None
    for sigobj, sigloc in stream:
        if query_mh is None:
            query_mh = sigobj.minhash.copy_and_clear()
            query_mh.track_abundance = False
        try:
            flat_mh = sigobj.minhash.to_mutable()
            flat_mh.track_abundance = False
            query_mh.merge(flat_mh)
        except (TypeError, ValueError) as exc:
            error(
                f"ERROR when merging signature '{sigobj}' ({sigobj.md5sum()[:8]}) from file {sigloc}"
            )
            error(str(exc))
            sys.exit(-1)

    if not len(stream):
        error("no signatures in query!?")
        sys.exit(-1)

    notify(f"loaded and merged {len(stream)} signatures")
    stream.report_picklist()
    return query_mh


class _KmerScan:
    """Streaming scan of sequence files against a merged query sketch:
    per record, sketch it, keep it when it intersects the query, and
    optionally emit matching sequences (FASTA) and k-mer/hash rows (CSV).
    Progress prints every ~1 Mbp."""

    def __init__(self, args, query_mh):
        from .. import sourmash_args

        self.args = args
        self.query_mh = query_mh
        self.query_hash_set = set(query_mh.hashes)
        self.found_mh = query_mh.copy_and_clear()
        self.is_protein = query_mh.moltype != "DNA" and not args.translate

        self.save_kmers = None
        self.kmer_w = None
        if args.save_kmers:
            self.save_kmers = sourmash_args.FileOutputCSV(args.save_kmers)
            self.save_kmers.open()
            self.kmer_w = csv.DictWriter(
                self.save_kmers.fp,
                fieldnames=["sequence_file", "sequence_name", "kmer", "hashval"],
            )
            self.kmer_w.writeheader()

        self.save_seqs = None
        if args.save_sequences:
            self.save_seqs = sourmash_args.FileOutput(args.save_sequences)
            self.save_seqs.open()

        self.n_files_searched = 0
        self.n_sequences_searched = 0
        self.n_bp_searched = 0
        self.n_kmers_found = 0
        self.n_sequences_found = 0
        self.n_bp_saved = 0
        self._progress_threshold = 1e6

    def close(self):
        if self.save_kmers:
            self.save_kmers.close()
        if self.save_seqs:
            self.save_seqs.close()

    def found_hashes(self):
        return self.query_hash_set.intersection(self.found_mh.hashes)

    def _sketch_record(self, name, sequence, filename):
        "One record -> sketch; None aborts/skips on invalid input."
        seq_mh = self.query_mh.copy_and_clear()
        if self.is_protein:
            seq_mh.add_protein(sequence)
            return seq_mh
        try:
            seq_mh.add_sequence(sequence, not self.args.check_sequence)
        except ValueError as exc:
            seqname = name if len(name) <= 40 else name[:37] + "..."
            notify(f"ERROR in sequence '{seqname}', file '{filename}'")
            notify(str(exc))
            if not self.args.force:
                sys.exit(-1)
            notify("(continuing)")
            return None
        return seq_mh

    def _record_matched(self, name, sequence, seq_mh, filename):
        if self.save_seqs:
            self.save_seqs.fp.write(f">{name}\n{sequence}\n")
            self.n_sequences_found += 1
            self.n_bp_saved += len(sequence)

        if self.kmer_w:
            for kmer, hashval in seq_mh.kmers_and_hashes(
                sequence, force=False, is_protein=self.is_protein
            ):
                if hashval in self.query_hash_set:
                    self.found_mh.add_hash(hashval)
                    self.n_kmers_found += 1
                    self.kmer_w.writerow(
                        dict(
                            sequence_file=filename,
                            sequence_name=name,
                            kmer=kmer,
                            hashval=hashval,
                        )
                    )

        self.found_mh += seq_mh.intersection(self.query_mh)

    def scan_file(self, filename):
        from .. import sequence_io

        self.n_files_searched += 1
        for name, seq_bytes in sequence_io.iter_records_bytes(filename):
            sequence = seq_bytes.decode("ascii")
            seq_mh = self._sketch_record(name, sequence, filename)
            if seq_mh is None:
                continue

            if seq_mh.intersection(self.query_mh):
                self._record_matched(name, sequence, seq_mh, filename)

            self.n_sequences_searched += 1
            self.n_bp_searched += len(sequence)

            if self.n_bp_searched >= self._progress_threshold:
                notify(
                    f"... searched {self.n_bp_searched} from {self.n_files_searched} files so far"
                )
                while self.n_bp_searched >= self._progress_threshold:
                    self._progress_threshold += 1e6


def kmers(args):
    """Retrieve k-mers/sequences matching the hashes of given sketches
    (reference `sig/__main__.py:1087-1340`)."""
    from ..search import format_bp

    set_quiet(args.quiet)
    stream = _SigStream(args)

    query_mh = _merged_query_for_kmers(stream)

    if query_mh.moltype == "DNA" and args.translate:
        error("ERROR: cannot use --translate with DNA sketches.")
        sys.exit(-1)

    if not query_mh:
        notify("ERROR: no hashes in query signature!?")
        sys.exit(-1)

    for line in (
        "",
        "merged signature has the following properties:",
        f"k={query_mh.ksize} molecule={query_mh.moltype} num={query_mh.num} scaled={query_mh.scaled} seed={query_mh.seed}",
        f"total hashes in merged signature: {len(query_mh)}",
        "",
        "now processing sequence files for matches!",
    ):
        notify(line)

    scan = _KmerScan(args, query_mh)
    try:
        for filename in args.sequences:
            notify(f"opening sequence file '{filename}'")
            scan.scan_file(filename)
    finally:
        scan.close()

    if not scan.n_sequences_searched:
        notify("ERROR: no sequences searched!?")
        sys.exit(-1)

    notify("DONE.")
    notify(
        f"searched {scan.n_sequences_searched} sequences from {scan.n_files_searched} files, containing a total of {format_bp(scan.n_bp_searched)}."
    )

    if scan.save_seqs:
        notify(
            f"matched and saved a total of {scan.n_sequences_found} sequences with {format_bp(scan.n_bp_saved)}."
        )
    if scan.kmer_w:
        notify(f"matched and saved a total of {scan.n_kmers_found} k-mers.")

    cont = len(scan.found_hashes()) / len(scan.query_hash_set)
    notify(f"found {len(scan.found_mh)} distinct matching hashes ({cont * 100:.1f}%)")

    if not scan.kmer_w and not scan.save_seqs:
        notify("NOTE: see --save-kmers or --save-sequences for output options.")


# ---------------------------------------------------------------------------
# manifest/collection management: check, collect, grep
# ---------------------------------------------------------------------------


def _relocated(loc, args, relpath):
    "Apply --abspath/--relpath rewriting to an internal location."
    if args.abspath:
        return os.path.abspath(loc)
    if args.relpath:
        if loc.startswith("/"):
            notify(f"** WARNING: cannot convert abspath {loc} into relative path.")
        return os.path.join(relpath, loc)
    return loc


def check(args):
    """Check signature db(s) against a picklist (reference
    `sig/__main__.py:1412-1550`)."""
    from ..picklist import PickStyle
    from ..manifest import CollectionManifest

    set_quiet(args.quiet, args.debug)
    moltype = sourmash_args.calculate_moltype(args)
    picklist = sourmash_args.load_picklist(args)
    sourmash_args.load_include_exclude_db_patterns(args)
    _extend_signatures_with_from_file(args)

    fatal = (
        (not picklist, "** No picklist provided?! Exiting."),
        (
            picklist and picklist.pickstyle == PickStyle.EXCLUDE
            and args.output_missing,
            "** ERROR: Cannot use an 'exclude' picklist with '-o/--output-missing'",
        ),
        (
            args.abspath and args.relpath,
            "** Cannot specify both --abspath and --relpath; pick one!",
        ),
    )
    for failed, message in fatal:
        if failed:
            error(message)
            sys.exit(-1)

    require_manifest = not args.no_require_manifest

    if args.relpath or (args.abspath and not args.save_manifest_matching):
        notify(
            "** WARNING: --abspath and --relpath only have effects when saving a manifest"
        )

    relpath = "."
    if args.relpath and args.save_manifest_matching:
        relpath = _relpath_to_output(args.save_manifest_matching)

    total_manifest_rows = CollectionManifest([])

    total_rows_examined = 0
    for filename in args.signatures:
        new_iloc = _relocated(filename, args, relpath)

        idx = sourmash_args.load_file_as_index(filename, yield_all_files=args.force)
        idx = idx.select(ksize=args.ksize, moltype=moltype)

        if idx.manifest is None and require_manifest:
            _manifest_required_abort(f"ERROR on filename '{filename}'.", "check")

        new_manifest = sourmash_args.get_manifest(idx, require=True)
        total_rows_examined += len(new_manifest)

        for row in new_manifest.select_to_manifest(picklist=picklist).rows:
            relocated_row = dict(row, internal_location=new_iloc)
            total_manifest_rows.add_row(relocated_row)

    notify(f"loaded {total_rows_examined} signatures.")

    sourmash_args.report_picklist(args, picklist)

    n_missing = len(picklist.pickset - picklist.found)
    if args.output_missing and n_missing:
        n_input = n_output = 0
        with sourmash_args.FileInputCSV(picklist.pickfile) as r, \
             open(args.output_missing, "w", newline="") as outfp:
            w = csv.DictWriter(outfp, fieldnames=r.fieldnames)
            w.writeheader()
            for row in r:
                n_input += 1
                if not picklist.matched_csv_row(row):
                    n_output += 1
                    w.writerow(row)
        notify(f"saved {n_output} non-matching rows of {n_input}"
               f" picklist rows to '{args.output_missing}'")
    elif args.output_missing:
        notify(
            f"(no remaining picklist entries; not saving to '{args.output_missing}')"
        )

    if args.save_manifest_matching:
        mf = total_manifest_rows
        if mf:
            mf.write_to_filename(args.save_manifest_matching,
                                 database_format=args.manifest_format)
            notify(f"wrote {len(mf)} matching manifest rows"
                   f" to '{args.save_manifest_matching}'")
        else:
            notify(f"(not saving matching manifest to"
                   f" '{args.save_manifest_matching}' because no matches)")

    if args.fail_if_missing and n_missing:
        error("** ERROR: missing values, and --fail-if-missing requested. Exiting.")
        sys.exit(-1)


def _open_collect_manifest(args):
    "Open or create the output manifest for `sig collect`."
    from ..manifest import CollectionManifest

    try:
        if args.manifest_format == "sql":
            from ..index.sqlite_index import SqliteCollectionManifest

            if args.merge_previous:
                return SqliteCollectionManifest.create_or_open(args.output)
            return SqliteCollectionManifest.create(args.output)

        assert args.manifest_format == "csv"
        if args.merge_previous and os.path.exists(args.output):
            collected_mf = CollectionManifest.load_from_filename(args.output)
        else:
            collected_mf = CollectionManifest()
        if not isinstance(collected_mf, CollectionManifest):
            raise Exception
        return collected_mf
    except Exception:
        error(
            f"ERROR loading '{args.output}' with --merge-previous. Is it of type {args.manifest_format}?"
        )
        sys.exit(-1)


def collect(args):
    """Collect signature metadata across many locations into one manifest
    (reference `sig/__main__.py:1553-1667`)."""
    set_quiet(False, args.debug)

    output_exists = os.path.exists(args.output)
    if output_exists and not args.merge_previous:
        _die(
            f"ERROR: '{args.output}' already exists!",
            "ERROR: please remove it, or use --merge-previous to merge",
        )
    if args.merge_previous and not output_exists:
        notify(
            f"WARNING: --merge-previous specified, but output file '{args.output}' does not already exist?"
        )

    if args.abspath and args.relpath:
        _die("** Cannot specify both --abspath and --relpath; pick one!")

    collected_mf = _open_collect_manifest(args)

    if args.merge_previous:
        notify(f"merging new locations with {len(collected_mf)} previous rows.")

    require_manifest = not args.no_require_manifest

    _extend_signatures_with_from_file(args, target_attr="locations")

    relpath = _relpath_to_output(args.output) if args.relpath else None

    for n_files, loc in enumerate(args.locations):
        notify(f"Loading signature information from {loc}.")
        if n_files and n_files % 100 == 0:
            notify(f"... loaded {len(collected_mf)} sigs from {n_files} files")

        idx = sourmash.load_file_as_index(loc)
        if idx.manifest is None and require_manifest:
            _manifest_required_abort(f"ERROR on location '{loc}'", "collect")

        mf = sourmash_args.get_manifest(idx)
        new_iloc = _relocated(loc, args, relpath)

        for row in mf.rows:
            collected_mf.add_row(dict(row, internal_location=new_iloc))

    if args.manifest_format == "csv":
        collected_mf.write_to_filename(
            args.output, database_format="csv", ok_if_exists=args.merge_previous
        )
    else:
        collected_mf.close()

    notify(f"saved {len(collected_mf)} manifest rows to '{args.output}'")
    return 0


def grep(args):
    """Extract signatures matching a name/filename/md5 pattern (reference
    `sig/grep.py:14-139`)."""
    import re

    from ..manifest import CollectionManifest

    set_quiet(args.quiet, args.debug)
    moltype = sourmash_args.calculate_moltype(args)
    picklist = sourmash_args.load_picklist(args)
    _extend_signatures_with_from_file(args)

    matcher = re.compile(args.pattern, re.IGNORECASE if args.ignore_case else 0)

    if args.invert_match:

        def search_pattern(vals):
            return all(not matcher.search(val) for val in vals)

    else:

        def search_pattern(vals):
            return any(matcher.search(val) for val in vals)

    require_manifest = not args.no_require_manifest

    # --count implies --silent; a silent run writes sigs nowhere (None sink)
    if args.count:
        args.silent = True
    sink_loc = None if args.silent else args.output
    notify(
        "(no signatures will be saved because of --silent/--count)."
        if args.silent
        else f"saving matching signatures to '{args.output}'"
    )
    save_sigs = sourmash_args.SaveSignaturesToLocation(sink_loc)
    if not args.silent:
        save_sigs.open()

    csv_obj = None
    if args.csv:
        csv_obj = sourmash_args.FileOutputCSV(args.csv)
        csv_fp = csv_obj.open()
        CollectionManifest.write_csv_header(csv_fp)

    total_rows_examined = 0
    for filename in args.signatures:
        idx = sourmash_args.load_file_as_index(
            filename, yield_all_files=args.force
        ).select(ksize=args.ksize, moltype=moltype, picklist=picklist)

        manifest = idx.manifest
        if manifest is None:
            if require_manifest:
                _manifest_required_abort(f"ERROR on filename '{filename}'.", "grep")
            manifest = sourmash_args.get_manifest(idx, require=False)

        total_rows_examined += len(manifest)
        sub_manifest = manifest.filter_on_columns(
            search_pattern, ["name", "filename", "md5"]
        )
        if args.csv:
            sub_manifest.write_to_csv(csv_fp)

        if args.count:
            print_results(f"{len(sub_manifest)} matches: {filename}")
        elif not args.silent:
            sub_picklist = sub_manifest.to_picklist()
            try:
                idx = idx.select(picklist=sub_picklist)
            except ValueError:
                _abort_no_picklist_support("grep", pipe_to="grep -")

            for ss in idx.signatures():
                save_sigs.add(ss)

    if not args.silent:
        notify(f"loaded {total_rows_examined} total that matched ksize & molecule type")
        if not save_sigs:
            _die("no matching signatures found!")
        notify(
            f"extracted {len(save_sigs)} signatures from {len(args.signatures)} file(s)"
        )
        save_sigs.close()

    if args.csv:
        notify(f"wrote manifest containing all matches to CSV file '{args.csv}'")
        csv_obj.close()

    if picklist:
        sourmash_args.report_picklist(args, picklist)
